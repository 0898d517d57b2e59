"""Hand-written Hopper kernels and their plain PyTorch versions.

  cosine_topk  — ``pruned_topk``: fused bound test, tile skip, fp32 scores
                 and top-k merge (``csrc/pruned_topk.cu``)
  bound_prune  — ``block_bounds``: the ``[M, NB]`` Eq. 13 bound matrix,
                 and ``block_bounds_select``: the same bounds reduced to
                 per-query-tile maxima and each query's best blocks
                 without writing the matrix (``csrc/block_bounds.cu``)
  leaf_gather  — ``gathered_topk``: ``pruned_topk`` over a compacted subset
                 of index blocks (the tree's kernel leaf stage; no kernel
                 of its own)
  ref          — plain oracles both build on
  _build       — ``nvcc`` on first use, ``ctypes`` loading
"""
