#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases (any failure exits non-zero; no phase's exception is caught):

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels from src/repro_torch/kernels/csrc, one nvcc per
   source, all at once;
3. main path: SearchEngine.build -> search at ann-benchmarks'
   glove-100-angular shape (1,183,514 x 100, 10,000 queries) on synthetic
   data, k = 10 and k = 100, checked against a brute force on the card.
   Two corpora of that shape: a mixture of 64 clusters, where the bound
   skips tiles, and one of 2,048 clusters, where it skips none.  Neither
   is GloVe: they say nothing of the bound's power on the real vectors.
   On the 64-cluster corpus also the engine's wide-prescan path
   (warm_start_blocks = 9, past the engine's select route of up to 8), which
   takes the [M, NB] bound matrix from block_bounds and sorts it, with the
   launch counts set to 0 before it and read after it.  Every search call
   launches pruned_topk once and merge_splits never (the merge is
   pruned_topk's epilogue);
4. K-loop and worst case: uniform data at nytimes-256-angular's shape
   (290,000 x 256, 10,000 queries, k = 10), where the bound prunes little;
5. each kernel against its plain PyTorch version on the card, at the main
   path's operands and on small cases (ub_cap, element stats, holes in
   row_valid, k = bn, no prune, D = 768, one query tile, empty-block
   sentinels), with times and bounds.  pruned_topk runs at one split and
   at the engine's chosen splits, each against the plain version at the
   same splits.  Its epilogue (the merge of the splits, written in the
   caller's order) against merge_splits_plain of the same launch's partial
   lists scattered by row_out, bit for bit, at k = 10 and 100 and at both
   splits; three routes timed in turns: the fused kernel, the kernel
   without its epilogue, and that kernel + merge_splits_kernel + the
   gathers by argsort(perm) that the engine ran before;
   block_bounds (bit for bit) and block_bounds_select (tile_max and best
   exactly equal) against their plain versions at the main path's
   operands and on sentinel, ragged and NaN cases; the bound stage's old
   route (the matrix, its argsort, the padded copy, the tile max) timed
   in turns against block_bounds_select, and kernel_inputs' outputs equal
   through both;
6. one torch.profiler window over a main-path search call: the device
   operations that take its time; no sort of the [M, NB] bound matrix
   among them, no merge_splits_kernel, and two sorts of [M] (the query
   sort), none to undo it;
7. the scan and tree backends (the tree with its scan leaf stage,
   leaf_eval="scan") on
   phase 3's clustered-64 index at k = 10 and 100 and on phase 4's
   uniform-256 index at k = 10, against those phases' brute force on the
   card, tie-aware; with the launch counts set to 0 before each call: a
   tree call launches block_bounds once per tree level and a scan call
   once, and pruned_topk and block_bounds_select never; block_bounds on
   the clustered-64 tree's node tables (the root's children, a middle
   level, the leaves, empty-subtree sentinels included) bit for bit
   against block_bounds_plain; each call timed with CUDA events (each is
   a host loop of one step per index block), and one uniform-256 tree call
   under torch.profiler for the card's busy share;
8. the tree backend with its kernel leaf stage (leaf_eval="kernel":
   the descent, then pruned_topk over the compacted union of the batch's
   surviving leaves, kernels/leaf_gather.py) on phase 3's clustered-64
   index at k = 10 and 100, on phase 4's uniform-256 index at k = 10, and
   on one query tile of 128 clustered-64 queries at k = 10: brute-force
   result sets; per call one pruned_topk launch and tree_levels + 1
   block_bounds launches (the levels, and the kept tiles' order); n_keep
   over n_blocks, tile_computed_frac, tree_prune_frac, the compaction's
   time alone, and the p50 beside the kernel backend's on the same index
   and queries; gathered_topk at the main path's operands against
   pruned_topk's plain version on the same compacted operands;
9. soundness near +-1: queries planted at pivot similarities
   +-(1 - 1e-3), +-(1 - 1e-5) and +-1 to every pivot of the clustered-64
   index; on the card, block_bounds over every block and every tree node
   plus the margin at least the float64 maximum similarity of the valid
   rows below it (and bit for bit with the plain version), and the kernel,
   scan and tree (both leaf stages) backends exact on those queries;
10. online mutation at full size: a kernel engine and a tree engine (kernel
   leaf stage) made on phase 3's index, each with its own engine.online()
   handle (which copies the index it mutates; phase 3's index must come
   out untouched), through the same operations: a. the reference's serve
   loop (12 steps of: insert 16 rows, delete 4 live ids, search 32
   queries; the tail fills and a block is appended), with the widened tree
   equal to build_tree bit for bit after the first insert; b. the top-1 rows
   of 1,000 phase-3 queries deleted, those queries searched; b2. 64 rows
   planted at float64 pivot cosines +-(1 - 1e-5) and +-1 inserted into the
   tombstones under the live tree, then phase 9's soundness check on the
   widened tree and phase 9's planted queries; c. 10,000 rows inserted (100
   planted as in b2, first), then phase 9's check on the grown index and
   its rebuilt tree and phase 9's planted queries; d. reoptimize, beside a
   fresh build over the same live rows without the planted ones.  After
   every step both engines equal a brute force on the card over exactly
   the live rows (the reference's online_matches_brute rule); 10,000-query
   searches after a, b, c and d print block_prune_frac beside the fresh
   build's;
11. single-device serving at full size, every search call counted and
   held to one pruned_topk and one block_bounds_select launch: zero-padded
   batch rows; kNN-LM decoding through the ContinuousBatcher over phase
   10's reoptimized kernel engine (1, 8 and 64 sequences as closed-loop
   clients, 64 tokens each, an insert and a delete made through run()
   half-way, each answer held to the brute force over the rows live when
   its batch ran; latency p50/p99, occupancy, QPS), each with its
   microbatches as they coalesced and zero-padded to 128 rows, beside the
   search alone at that many rows; the KNNDatastore over phase 3's engine
   (knn_probs against a plain computation, add_pairs, delete);
   find_near_duplicates on 100,000 embed_tokens documents against a brute
   force on the card; and the fused merge of pruned_topk timed at one
   query tile of 128 and of 32;
12. kNN-LM serving through the port's model at full width: the launcher
   (repro_torch.launch.serve) at tinyllama-1.1b with its defaults; then
   tinyllama-1.1b at full depth (22 layers, d_model 2048, bf16
   activations) with random weights from the seed, a datastore from
   KNNDatastore.from_corpus over 512 synthetic sequences of 2,048 tokens
   (1,048,064 keys of width 2048, the engine's defaults), and 8 and 64
   prompts of 256 tokens decoded 32 greedy tokens through Engine with kNN
   off and on (k = 8, lambda = 0.25).  Checks: every kNN-on step's lookup
   against a brute force over the keys on the card, with one pruned_topk
   and one block_bounds_select launch per step (counts zeroed before each);
   cache decode against teacher forcing in bf16; phase 9's soundness
   check over every block at d = 2048; and the model's CUDA tensors
   straight into from_corpus, add_pairs, ContinuousBatcher.submit and
   find_near_duplicates.  It prints harvest and build s, prefill and
   decode tok/s, the search's and the model's ms per step, and the peak
   memory, each beside the card's name and power limit;
13. kNN-LM serving across the model families at full width and depth,
   one model on the card at a time: granite-moe-1b-a400m (MoE),
   zamba2-1.2b (Mamba2 and the shared attention block), rwkv6-1.6b,
   internvl2-1b (vlm) and whisper-small (whisper), random weights from the
   seed.  Each: the launcher at its defaults (--arch <arch> --knn), a store
   from from_corpus over 128 sequences of 1,024 tokens (130,944 keys of
   the model's width), and phase 12's traffic.  Checks: a. every kNN-on
   lookup exact with one pruned_topk and one block_bounds_select launch a
   step; b. cache decode against teacher forcing (an MoE's with the
   teacher's expert choices replayed, in bf16 and in float32); c. rwkv6's chunked WKV
   against its scan and Mamba2's chunked path against its recurrent
   update, one layer in float32 at full width; d. two decodes from one
   prefilled cache give the same tokens.  mixtral-8x22b (141 B params) and
   qwen2-72b do not fit one card at fp32 and are not run;
14. training at full width (the reference's whole-system flow): a.
   tinyllama-1.1b at full width, cut to 11 of its 22 layers (phase 16
   trains it at full depth), remat on: find_near_duplicates
   on the card over the 1,920 passages of 128 tokens of the run's batches
   (32 planted copies: all found, the pairs equal to a brute force, one
   pruned_topk and one block_bounds_select launch), 30 steps through
   Trainer at B = 8, S = 1,024 (warmup_cosine as launch/train.py sets it;
   every loss and grad_norm finite, the last 5 losses' mean below the
   first 5's), then from_corpus with the trained weights over 128 x 1,024
   tokens and 64 greedy decode steps at B = 8 with kNN off and on (every
   lookup exact, one launch of each kernel a step); b. an async
   checkpoint at step 10 from a fresh Trainer, another fresh Trainer
   resumes from it to step 20: its losses within 1e-4 of a's; c. a
   2-layer float32 copy at full width, one loss and backward on the card
   against the same in float64 on the CPU (loss within 1e-5 relative,
   each gradient within 1e-4 of its leaf's max); d. one step with int8 gradient compression, |err|
   within the quantizer's half step; e. one train step of each phase-13
   family at full width and depth (B = 2, S = 1,024 or its max_seq_len),
   every parameter a finite gradient, the MoE router's nonzero, and a
   second step on the same batch lowers the loss.  It prints ms a step,
   tokens/s, peak memory, the checkpoint's GB and save and restore
   seconds, each beside the card's name and power limit;
15. the sharded search layer (run after phase 9, while phase 3's engine
   and brute force are held): phase 3's clustered-64 corpus built as 8
   shards (147,940 rows, 1,156 blocks each) on a one-rank CUDA DeviceMesh
   in this process through SearchEngine.build(db, mesh=..., n_shards=8),
   counts zeroed before the build and no scan in the phase.  a. flat
   (tree_shards=False) at k = 10 and 100: per call exactly 8 pruned_topk
   and 8 block_bounds_select launches, block_bounds and merge_splits none;
   b. the shard trees (an engine on the same index, tree_shards left to
   the auto rule, which must turn them on) at k = 10 and 100: per call 8
   pruned_topk (gathered_topk's) and 8 x (levels + 1) block_bounds
   launches, the levels read off the shard trees; every answer of a and b
   equal to phase 3's brute force and single-device engine (tie-aware
   within 1e-5); c. the tree engine's online handle: inserts of 16 rows,
   deletes of 4, an insert that appends a block to every shard and a
   reoptimize, each search after them equal to the brute force over the
   live rows.  It prints build s, p50 and QPS, the weighted prune
   fractions, the kept blocks per shard, the profile's busy ms by kernel,
   insert and delete us and peak memory, each beside the card's name and
   power limit.

16. training on a (data, model) mesh, on one card (one-rank NCCL
   DeviceMeshes (1, 1) ("data", "model") and (1, 1, 1) ("pod", "data",
   "model"); no collective of more than one card runs): a. tinyllama-1.1b
   at full width and depth, fp32 params and moments, 5 steps at B = 8,
   S = 1,024 under default_rules(fsdp=True) through place_state,
   make_process_local_array and the mesh train step, each loss within
   1e-5 relative of the same seed's host steps in this process, the
   largest parameter difference after them reported, every leaf's
   placement (local shape against global) printed; then one step of
   rwkv6-1.6b (4 layers) and zamba2-1.2b (6 layers, one shared block) at
   full width, B = 8, S = 1,024, on the same mesh, loss and every
   parameter bit for bit with the host path's; b. granite-moe-1b-a400m
   at full width, B = 2, on the (1, 1, 1) mesh: every MoE layer through
   _moe_sharded, one step's loss and gradients equal to the local path's
   within 1e-5; c. b's parameters checkpointed and restored with
   restore(shardings=) onto remesh([0]), every leaf a DTensor there, bit
   for bit; d. one sharded search over ("pod", "data") of the (1, 1, 1)
   mesh equal to a brute force; e. the "model" split of the mesh train
   step (placement.model_split), which a one-rank mesh cannot show:
   tinyllama-1.1b's first block at full width, B = 8, S = 1,024, its
   attention and its GLU MLP computed as every share r = 0..tp-1 for tp in
   2, 4, 16 through the same split code with no collective (group None),
   in bf16 and fp32 activations; the shares' outputs, input gradients and
   parameter gradients summed against the whole layer within 3e-2 (bf16)
   and 1e-4 (fp32) of each tensor's largest magnitude, and each share's
   FLOPs (FlopCounterMode) printed beside the whole's, at most the whole's
   / tp plus the K/V projection where the KV heads stay whole; then its
   head (V = 32,000, d = 2,048; its lm_head.w, and tied to the embedding's
   table) as every share of the same tps: the shares' logits concatenated,
   and the hidden and weight gradients of the vocab-parallel loss combined
   by hand from the shares (the max, the sum of exps, the gold logit),
   against the whole head's within the same 3e-2 / 1e-4, that loss against
   chunked_ce on the whole logits within 1e-3 / 1e-5 relative, each share
   V / tp columns wide and its FLOPs at most the whole head's / tp; then
   rwkv6-1.6b's first time mix and channel mix and zamba2-1.2b's first
   Mamba2 layer the same way (the SSD's shares fed their gate norm's
   summed statistic by hand), within 3e-2 (bf16) and 1e-3 (fp32), each
   share's FLOPs at most the whole's / tp plus what every share computes
   whole, each row beside the whole layer's own change under a one-ulp
   perturbation of its input.  The
   training path launches no kernel (counted: 0); d launches pruned_topk
   and block_bounds_select once per shard.  It prints ms a step beside
   phase 14's and the host path's, peak GB, and the card's name and power
   limit.

17. a. (run after phase 5, while phase 3's index is held) pruned_topk over
   a bf16 db: phase 3's clustered-64 index with its db cast to bf16, its
   10,000 queries at k = 10 and 100 at the engine's operands and splits;
   the launch count set to 0 before one launch a k and read after it; the
   kernel against its plain version on the same bf16 rows (phase 5a's
   contract) and against phase 3's fp32 brute force within 2e-2 (the
   reference's tolerance); its ms beside the fp32 kernel's at the same
   operands and splits, in turns, with tile_computed_frac;
   b. the dry-run held to the card: tinyllama-1.1b at full width and
   depth, train_4k at B = 1, S = 4,096 and decode_32k at B = 1 over a
   32,768-token cache, each first lowered under fake tensors
   (launch.dryrun.lower_cell on a (1, 1) CUDA mesh of a fake world of one
   rank), then built with random weights from the seed on a one-rank NCCL
   (1, 1) DeviceMesh and its step run on the card: argument_bytes equal to
   the placed state's bytes, argument_bytes + temp_bytes within 25 % of
   the step's max_memory_allocated, the mesh decode's logits and cache
   equal bit for bit to the host path's decode_step; then one train step
   of tinyllama-1.1b at full width and depth, fp32 params and AdamW
   moments, at B = 1, S = 16,384 (512 score tiles of 64 MiB a layer,
   which fit the card only because the backward recomputes each tile's
   body): the loss finite and within 1e-6 relative of a no_grad
   forward's on the same batch, its ms and peak GiB printed; no kernel
   launches; c. run_cell for tinyllama-1.1b and granite-moe-1b-a400m x
   train_4k and decode_32k, each on the pod and the multipod mesh at rank
   0 of a fake world of 256 and 512 ranks (both steps under the "model"
   split: train computes each rank's heads, ffn and vocab columns, decode
   its ffn and vocab columns), every cell OK, with its memory per rank,
   FLOPs and collective bytes by kind printed (a prefill_32k cell takes
   13-48 min of host, past the script's time: the dry-run's sweep records
   those).  The fake runs of b and c
   take minutes of host CPU and no card time: they start with the script,
   in processes of their own at a low priority (start_dryruns), and
   phase 17 waits for them; every process the script starts is ended
   before it exits.

Every configuration's block_prune_frac is printed beside its value under
the point bound (PERF.md §6), since the Eq. 13 bound now runs over the
query's interval and the sound block intervals.

Before the last line it prints one JSON object with a "kernels" list; the
last line is {"ok": true, "device": {...}}.  Without a CUDA GPU it exits 2
and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: fp32 operations the Eq. 13 bound over the box [a_lo, a_hi] x [lo, hi]
#: needs, an FMA counting 2 as in the peak rate, each term computed once at
#: the coarsest index it depends on.  Per (query, tile, pivot): the test
#: that picks the nearest corner, x*y + sqrt(1-x^2)*sqrt(1-y^2) there as a
#: multiply and an FMA (3), two compares and their "and" for the intervals
#: meeting, the select of 1, the min over pivots.
BOUND_OPS_QBP = 9
#: per (tile, pivot): sqrt(max(0, (1 - s)(1 + s))) at lo and at hi, and lo > hi
BOUND_OPS_BP = 11
#: per (query, pivot): the two float32 neighbours of a, clamped to [-1, 1],
#: and sqrt((1 - x)(1 + x)) of each
BOUND_OPS_QP = 14
#: per (query, tile) in pruned_topk: margin add, compare with tau, and live
SKIP_OPS = 3

#: glove-100-angular's shape; 64 unit centres plus N(0, 0.05^2) noise per
#: coordinate (10th-neighbour similarity ~0.86): the bound skips about a
#: third of the tiles, so the path runs both the skip and the merge
CLUSTERED64 = dict(name="clustered-64 at glove-100-angular shape", key="clustered64",
                   n=1_183_514, d=100, m=10_000, ks=(10, 100), centers=64,
                   noise=0.05)
#: the same shape, 2,048 centres at noise 0.08: the bound skips no tile
CLUSTERED2048 = dict(CLUSTERED64, name="clustered-2048 at glove-100-angular shape",
                     key="clustered2048", ks=(10,), centers=2048, noise=0.08)
UNIFORM256 = dict(name="uniform at nytimes-256-angular shape", key="uniform256",
                  n=290_000, d=256, m=10_000, ks=(10,), centers=0, noise=0.0)
REPS = 5
#: timed calls of each scan / tree configuration in phase 7, after one
#: warm-up: each call is a host loop of one step per index block
SCAN_TREE_REPS = 3
#: turns of the three merge routes in phase 5a': the epilogue is tens of
#: microseconds inside a 65-180 ms kernel whose calls spread by ~0.5 ms
MERGE_TURNS = 15
#: rows of the corpus behind the small kernel cases
SMALL_N = 20_000
#: block_prune_frac of each configuration under the point bound (the float32
#: query similarity and the float32 block intervals), as this script
#: measured it on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6); None: not
#: recorded
POINT_BOUND_PRUNE = {"clustered64": {"k10": 0.3156, "k100": 0.3121, "wide_prescan_k10": None},
              "clustered2048": {"k10": 0.0}, "uniform256": {"k10": 0.0},
              "scan_tree": {"clustered64": {"scan_k10": 0.4239, "scan_k100": 0.3552,
                                            "tree_k10": 0.4242, "tree_k100": 0.3553},
                            "uniform256": {"scan_k10": 0.0, "tree_k10": 0.0}}}
#: pivot similarities phase 9 plants its queries at, and queries per
#: (pivot, similarity)
NEAR_PM1 = (1 - 1e-3, 1 - 1e-5, 1.0, -(1 - 1e-3), -(1 - 1e-5), -1.0)
NEAR_PM1_REPEATS = 4
#: queries of phase 8's one-tile batch
TILE_BATCH = 128
#: phase 17a: the bf16 db's top-k within this of the fp32 brute force (the
#: reference's own tolerance, tests/test_kernels.py test_cosine_topk_dtypes)
BF16_DB_ATOL = 2e-2
#: phase 17b: the dry-run's cells held to the card, (shape, input_specs
#: scale): train_4k at B = 1, S = 4,096; decode_32k at B = 1 over a
#: 32,768-token cache
DRYRUN_ARCH = "tinyllama-1.1b"
DRYRUN_CARD_CELLS = (("train_4k", 1 / 256), ("decode_32k", 1 / 128))
#: the dry-run's predicted peak (argument + temporary bytes) within this
#: share of the card's measured one
DRYRUN_MEM_RTOL = 0.25
#: phase 17c: production cells through run_cell, each on the pod and the
#: multipod mesh at rank 0 of a fake world
DRYRUN_POD_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "decode_32k"),
                    ("granite-moe-1b-a400m", "train_4k"),
                    ("granite-moe-1b-a400m", "decode_32k"))
#: seconds phase 17 waits for the dry-run's processes, started with the script
DRYRUN_WAIT_S = 600
#: phase 17b: one train step of DRYRUN_ARCH at full width and depth at B = 1
#: over this many tokens: 32 x 16 flash-attention tiles of 512 x 1,024 a
#: layer, 64 MiB each in fp32, which fit the card only because the backward
#: recomputes each tile's body (the reference's memory law)
LONG_SEQ = 16_384
#: its loss against a no_grad forward's on the same batch, relative
LONG_LOSS_RTOL = 1e-6


def log(*a):
    print(*a, flush=True)


def synth(spec, seed):
    """Datastore and queries of the spec's shape, from numpy's generator.
    centers > 0: a clustered mixture, queries drawn from the same mixture
    (not copied from rows); centers == 0: uniform on the sphere."""
    rng = np.random.default_rng(seed)
    n, d, m = spec["n"], spec["d"], spec["m"]
    if spec["centers"] == 0:
        return (rng.standard_normal((n, d), dtype=np.float32),
                rng.standard_normal((m, d), dtype=np.float32))
    c = rng.standard_normal((spec["centers"], d), dtype=np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return mixture_draw(rng, c, n, spec["noise"]), mixture_draw(rng, c, m, spec["noise"])


def mixture_centres(spec, seed):
    """The unit centres synth(spec, seed) draws its mixture around."""
    c = np.random.default_rng(seed).standard_normal((spec["centers"], spec["d"]),
                                                    dtype=np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def mixture_draw(rng, c, count, noise):
    """``count`` rows of the mixture around the centres ``c``."""
    x = rng.standard_normal((count, c.shape[1]), dtype=np.float32)
    x *= noise
    x += c[rng.integers(0, len(c), count)]
    return x


def cuda_ms(fn, reps):
    """Per-call milliseconds of ``fn`` on the card (CUDA events), each call
    timed alone; returns the list."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def brute_topk(qn, dbn, k, chunk=500):
    """Exact top-k on the card: torch matmul + topk over query chunks."""
    sims, ids = [], []
    for s in range(0, qn.shape[0], chunk):
        v, i = torch.topk(qn[s:s + chunk] @ dbn.T, k, dim=1)
        sims.append(v)
        ids.append(i)
    return torch.cat(sims), torch.cat(ids)


def tie_aware_mismatches(s_got, i_got, s_want, i_want, tol):
    """Rows whose id sets differ beyond near-ties: every id in one set and
    not the other must score within ``tol`` of that row's k-th best."""
    bad = 0
    for r in np.nonzero((np.sort(i_got, 1) != np.sort(i_want, 1)).any(1))[0]:
        extra = set(i_got[r]) ^ set(i_want[r])
        kth = min(s_got[r, -1], s_want[r, -1])
        got = dict(zip(i_got[r], s_got[r]))
        got.update(zip(i_want[r], s_want[r]))
        if any(abs(got[i] - kth) > tol for i in extra):
            bad += 1
    return bad


def bounds_diff(got, want):
    """Max |difference| of two bound matrices; +inf when their -inf
    (empty block) positions differ."""
    if not bool((torch.isneginf(got) == torch.isneginf(want)).all()):
        return float("inf")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def bounds_equal(got, want):
    """Equal bit for bit where finite or infinite, NaN at the same places
    (two NaNs may differ in their bits)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0)))


def nan_first(best, ub):
    """On every row of ``ub`` that holds NaN, ``best`` starts with its
    lowest NaN blocks in ascending order (block_bounds_select ranks NaN
    above every number, ties to the lower block)."""
    nan = torch.isnan(ub)
    rows = nan.any(1)
    n_pre = best.shape[1]
    first = torch.argsort((~nan[rows]).int(), dim=1, stable=True)[:, :n_pre]
    have = nan[rows].sum(1, keepdim=True) > torch.arange(n_pre, device=ub.device)
    return bool(((best[rows] == first) | ~have).all())


def matrix_route(qp, lo, hi, ub_cap=None, *, bm, n_pre):
    """The engine's bound stage as it was before block_bounds_select, kept
    here (not in the package) as its yardstick: the [M, NB] matrix from
    block_bounds, a stable descending argsort of all of it for the warm
    start's best blocks, and a -inf-padded copy of it for each query tile's
    max.  Same signature and outputs as block_bounds_select."""
    from repro_torch.kernels.bound_prune import block_bounds

    ub = block_bounds(qp, lo, hi, ub_cap)
    best = torch.argsort(ub, dim=1, descending=True, stable=True)[:, :n_pre]
    m, nt = ub.shape
    mp = -(-m // bm) * bm
    ub_p = torch.cat([ub, ub.new_full((mp - m, nt), float("-inf"))])
    return ub_p.reshape(mp // bm, bm, nt).amax(1), best


def kernel_inputs_equal(a, b):
    """Two kernel_inputs results hold equal tensors (torch.equal) and equal
    values everywhere."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and torch.equal(x, y)
        if isinstance(x, (tuple, list)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[n], y[n]) for n in x)
        return x == y
    return same(a, b)


def kernel_inputs_by_route(kernel_inputs, route, *args, **kw):
    """kernel_inputs with the bound stage taken by ``route`` (a function of
    block_bounds_select's signature) for the length of the call."""
    from repro_torch.search import backends

    saved = backends.block_bounds_select
    backends.block_bounds_select = route
    try:
        return kernel_inputs(*args, **kw)
    finally:
        backends.block_bounds_select = saved


def phase_search(spec, seed, SearchEngine, kernels, wide=None, absent=()):
    """Build and search one corpus through the engine; counts every kernel
    launch of this run: each of ``kernels`` must launch, ``kernels[0]``
    (pruned_topk) once per search call, and none of ``absent``.  ``wide``:
    ``(warm_start_blocks, kernels)`` of the wide-prescan path, driven after
    the main path on the same index with the counts set to 0 before it.
    Returns the engine, queries, the report and the brute force on the card
    ({k: (sims, ids)}, numpy) that the results were held to."""
    db_np, q_np = synth(spec, seed)
    for kern in kernels + absent + (wide[1] if wide else ()):
        kern.launches = 0
    calls = []
    t0 = time.perf_counter()
    eng = SearchEngine.build(db_np, n_pivots=16, block_size=128)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = torch.from_numpy(q_np).cuda()
    out = {"build_s": build_s, "n_blocks": eng.n_blocks}
    results = {}

    def timed(name, engine, k):
        engine.search(q, k)                                # warm-up
        ms = cuda_ms(lambda: engine.search(q, k), REPS)
        sims, ids, st = engine.search(q, k)
        calls.append(REPS + 2)
        results[name] = (k, sims, ids)
        p50 = float(np.median(ms))
        out[name] = {"p50_ms": p50, "qps": spec["m"] / (p50 / 1e3), "ms": ms,
                     "block_prune_frac": float(st.block_prune_frac)}
        return f"{name}: p50 {p50:.3f} ms/call, QPS {out[name]['qps']:.1f}, " \
               f"block_prune_frac {out[name]['block_prune_frac']:.4f}"

    said = [timed(f"k{k}", eng, k) for k in spec["ks"]]
    out["launches"] = {kern.__name__: kern.launches for kern in kernels + absent}
    out["search_calls"] = sum(calls)
    log(f"[{spec['name']}] build {build_s:.3f} s, {eng.n_blocks} blocks; "
        + "; ".join(said) + f"; launches {out['launches']} in {sum(calls)} "
        f"search calls")
    for kern in kernels:
        check(kern.launches > 0, f"{spec['name']}: kernel {kern.__name__} never launched")
    check(kernels[0].launches == sum(calls),
          f"{spec['name']}: {kernels[0].__name__} launched {kernels[0].launches} "
          f"times in {sum(calls)} search calls")
    for kern in absent:
        check(kern.launches == 0, f"{spec['name']}: {kern.__name__} launched")
    if wide is not None:
        blocks, wide_kernels = wide
        for kern in kernels + absent + wide_kernels:
            kern.launches = 0
        wide_eng = SearchEngine(eng.index, warm_start_blocks=blocks)
        said = timed("wide_prescan_k10", wide_eng, 10)
        seen = {kern.__name__: kern.launches for kern in kernels + absent + wide_kernels}
        out["wide_prescan_k10"].update(warm_start_blocks=blocks, launches=seen)
        log(f"[{spec['name']}] wide prescan (warm_start_blocks={blocks}) {said}; "
            f"launches {seen}")
        for kern in wide_kernels:
            check(seen[kern.__name__] > 0,
                  f"wide prescan path: kernel {kern.__name__} never launched")
        for kern in absent:
            check(seen[kern.__name__] == 0, f"wide prescan path: {kern.__name__} launched")
        del wide_eng

    # exactness: result sets equal a brute force on the card
    dbn = torch.nn.functional.normalize(torch.from_numpy(db_np).cuda(), dim=1)
    qn = torch.nn.functional.normalize(q, dim=1)
    brute = {}
    for name, (k, sims, ids) in results.items():
        if k not in brute:
            brute[k] = tuple(x.cpu().numpy() for x in brute_topk(qn, dbn, k))
        out[name]["max_abs_err_vs_brute"] = exactness(spec, name, k, sims, ids, brute)[0]
    del dbn
    return eng, q, out, brute


def exactness(spec, name, k, sims, ids, brute):
    """A search result against the brute force on the card (``brute[k]``,
    numpy): finite sims of the right shape, no -1 id, the same result set
    up to near-ties (1e-5); fails otherwise.  Returns (max |sim diff|,
    rows differing beyond near-ties)."""
    s_b, i_b = brute[k]
    s_g, i_g = sims.cpu().numpy(), ids.cpu().numpy()
    check((i_g >= 0).all(), f"{spec['name']} {name}: -1 id with k <= rows")
    check(np.isfinite(s_g).all() and s_g.shape == (spec["m"], k),
          f"{spec['name']} {name}: non-finite or misshapen sims")
    err = float(np.abs(s_g - s_b).max())
    bad = tie_aware_mismatches(s_g, i_g, s_b, i_b, 1e-5)
    log(f"[{spec['name']}] {name} vs brute force: max |sim diff| {err:.3e}, "
        f"rows differing beyond near-ties: {bad}")
    check(err <= 1e-5 and bad == 0, f"{spec['name']} {name}: not exact")
    return err, bad


def phase_scan_tree(spec, eng, q, brute, ks, kernel_prune, kernels, profile=()):
    """Phase 7: the scan and tree backends on ``eng``'s index at each k of
    ``ks``, each configuration called once with the launch counts of
    ``kernels`` (block_bounds, block_bounds_select, pruned_topk) set to 0
    just before and read just after, then timed over SCAN_TREE_REPS calls
    after that one warm-up; results held to ``brute``.  ``kernel_prune``:
    the kernel backend's block_prune_frac per k on the same queries (phase
    3 or 4), printed beside the tree's.  The configurations named in
    ``profile`` (e.g. "tree_k10") also run one call under torch.profiler
    (device_busy; a 9,247-step call takes minutes there).  Returns the
    report and the tree the tree engine built."""
    from repro_torch.search import SearchEngine

    block_bounds, select, topk = kernels
    out = {}
    for backend in ("scan", "tree"):
        # the tree's scan leaf stage by name (on the card "auto" is the
        # kernel leaf stage, phase 8)
        engine = SearchEngine(eng.index, backend=backend,
                              **({"leaf_eval": "scan"} if backend == "tree" else {}))
        for k in ks:
            name = f"{backend}_k{k}"
            for kern in kernels:
                kern.launches = 0
            sims, ids, st = engine.search(q, k)
            torch.cuda.synchronize()
            seen = {kern.__name__: kern.launches for kern in kernels}
            levels = st.extras.get("tree_levels")
            want_bb = levels if backend == "tree" else 1
            check(seen == {block_bounds.__name__: want_bb, select.__name__: 0,
                           topk.__name__: 0},
                  f"{spec['name']} {name}: launches {seen}, want block_bounds "
                  f"{want_bb} and no other kernel")
            err, _ = exactness(spec, name, k, sims, ids, brute)
            del sims, ids
            ms = cuda_ms(lambda: engine.search(q, k), SCAN_TREE_REPS)
            r = {"ms": ms, "p50_ms": float(np.median(ms)), "reps": SCAN_TREE_REPS,
                 "warmup": 1, "launches": seen, "max_abs_err_vs_brute": err,
                 "block_prune_frac": float(st.block_prune_frac),
                 "kernel_block_prune_frac": kernel_prune[k]}
            if backend == "tree":
                r.update(tree_levels=levels,
                         tree_prune_frac=float(st.tree_prune_frac),
                         tree_node_eval_frac=float(st.tree_node_eval_frac))
            if name in profile:
                r["device"] = device_busy(lambda: engine.search(q, k), r["p50_ms"])
            out[name] = r
            said = (f"[{spec['name']}] {name}: p50 {r['p50_ms']:.1f} ms/call over "
                    f"{SCAN_TREE_REPS} calls after 1 warm-up {['%.1f' % x for x in ms]}, "
                    f"block_prune_frac {r['block_prune_frac']:.4f}")
            if backend == "tree":
                said += (f", tree_prune_frac {r['tree_prune_frac']:.4f}, "
                         f"tree_node_eval_frac {r['tree_node_eval_frac']:.4f}, "
                         f"tree_levels {levels}")
            said += f"; launches {seen}"
            if "device" in r:
                dev = r["device"]
                said += (f"; under the profiler one call kept the card busy "
                         f"{dev['busy_ms']:.1f} ms in {dev['kernels']} kernels, "
                         f"{dev['busy_share']:.3f} of the p50; top: "
                         + "; ".join(f"{n[:40]} {ms:.1f} ms" for n, ms in dev["top"]))
            if kernel_prune[k] < r["block_prune_frac"]:
                said += (f"; the kernel backend's block_prune_frac on the same "
                         f"queries is lower: {kernel_prune[k]:.4f} (of query-tile "
                         f"x kernel-tile pairs)")
            log(said)
        if backend == "tree":
            tree = engine._tree_index
        del engine
    return out, tree


def device_busy(fn, p50_ms, top=4):
    """One call of ``fn`` under torch.profiler: the card's busy time (the
    sum of the device's own events, kernels and copies; an aten operation's
    device time is its kernels' and is not counted again), the number of
    those events, their share of ``p50_ms`` (the call's time without the
    profiler) and the events that took the most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            ops.append((e.key, us / 1e3, e.count))
    ops.sort(key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in ops)
    return {"busy_ms": busy, "busy_share": busy / p50_ms,
            "kernels": int(sum(n for *_, n in ops)),
            "top": [(name, ms) for name, ms, _ in ops[:top]]}


def node_table_checks(tree, qp, levels):
    """block_bounds on the tree's node tables of ``levels`` against
    block_bounds_plain, bit for bit; every empty subtree's column -inf.
    Returns {level: {nodes, empty, equal, kernel_ms, plain_ms}}; fails if
    one differs."""
    from repro_torch.kernels.bound_prune import block_bounds, block_bounds_plain

    out = {}
    for level in levels:
        base = 1 << level
        lo, hi = tree.node_lo[base:2 * base], tree.node_hi[base:2 * base]
        empty = ~tree.node_valid[base:2 * base]
        got = block_bounds(qp, lo, hi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = block_bounds_plain(qp, lo, hi)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = bounds_equal(got, want) and bool(torch.isneginf(got[:, empty]).all())
        del got, want
        ms = cuda_ms(lambda: block_bounds(qp, lo, hi), REPS)
        out[level] = {"nodes": base, "empty": int(empty.sum()), "equal": equal,
                      "kernel_ms": float(np.median(ms)), "plain_ms": plain_ms}
        log(f"[tree nodes] level {level}: {base} nodes ({out[level]['empty']} empty), "
            f"block_bounds equal to its plain version bit for bit, sentinels -inf: "
            f"{equal}; kernel {out[level]['kernel_ms']:.3f} ms, plain {plain_ms:.1f} ms")
        check(equal, f"block_bounds on the tree's level {level} differs from its "
                     f"plain version")
    return out


def kept_blocks(eng, q, k):
    """The tree engine's kernel leaf stage up to its compaction, replayed:
    (keep, sorted qn, sorted qp, sorted tau0, perm), as _run_kernel_leaves
    computes them (no joint cap: the engines here run n_pivots = 0)."""
    from repro_torch.search import backends as bk
    from repro_torch.search import tree as t_tree

    tree = eng._tree_index
    qn, qp = bk.prep_queries(eng.index, q)
    tau0, alive, _, _ = t_tree._seed_and_descend(
        tree, qn, qp, k, warm_start=eng.warm_start,
        warm_start_blocks=eng.warm_start_blocks, margin=eng.margin)
    keep = torch.nonzero(alive.any(0))[:, 0].int()
    perm = bk.query_sort_perm(qp).int()
    return keep, qn[perm], qp[perm], tau0[perm], perm


def phase_tree_kernel(spec, eng, q, brute, ks, kernel_p50, kernels, prefix="tree_kernel",
                      profile=()):
    """Phase 8: the tree backend with its kernel leaf stage on ``eng``'s
    index at each k of ``ks``: one call with the launch counts of
    ``kernels`` (block_bounds, block_bounds_select, pruned_topk) set to 0
    just before and read just after (pruned_topk once, block_bounds
    tree_levels + 1 times, the select kernel never), results held to
    ``brute``, then REPS timed calls after it; the compaction's gathers
    timed alone on the call's kept blocks.  ``kernel_p50``: the kernel
    backend's p50 per k on the same index and queries.  The configurations
    named in ``profile`` also run one call under torch.profiler
    (device_busy).  Returns the report and the engine."""
    from repro_torch.kernels.leaf_gather import compact_blocks
    from repro_torch.search import SearchEngine
    from repro_torch.search.tree import TreeBackend

    block_bounds, select, topk = kernels
    engine = SearchEngine(eng.index, backend="tree")        # leaf_eval "auto"
    check(TreeBackend._resolve_leaf_eval(engine) == "kernel",
          "the tree engine on the card does not resolve leaf_eval to the kernel")
    out = {}
    for k in ks:
        name = f"{prefix}_k{k}"
        for kern in kernels:
            kern.launches = 0
        sims, ids, st = engine.search(q, k)
        torch.cuda.synchronize()
        seen = {kern.__name__: kern.launches for kern in kernels}
        levels = st.extras["tree_levels"]
        check(seen == {block_bounds.__name__: levels + 1, select.__name__: 0,
                       topk.__name__: 1},
              f"{spec['name']} {name}: launches {seen}, want block_bounds "
              f"{levels + 1}, pruned_topk 1 and no select kernel")
        err, _ = exactness(spec, name, k, sims, ids, brute)
        del sims, ids
        ms = cuda_ms(lambda: engine.search(q, k), REPS)
        keep = kept_blocks(engine, q, k)[0]
        check(keep.numel() == st.extras["n_keep"], f"{name}: kept blocks differ")
        comp_ms = cuda_ms(lambda: compact_blocks(engine.index, keep), REPS)
        r = {"ms": ms, "p50_ms": float(np.median(ms)), "reps": REPS, "warmup": 1,
             "launches": seen, "max_abs_err_vs_brute": err,
             "n_keep": int(st.extras["n_keep"]), "n_blocks": eng.n_blocks,
             "block_prune_frac": float(st.block_prune_frac),
             "tile_computed_frac": float(st.tile_computed_frac),
             "tree_prune_frac": float(st.tree_prune_frac),
             "tree_node_eval_frac": float(st.tree_node_eval_frac),
             "tree_levels": levels, "compaction_ms": float(np.median(comp_ms)),
             "kernel_backend_p50_ms": kernel_p50[k]}
        if name in profile:
            r["device"] = device_busy(lambda: engine.search(q, k), r["p50_ms"], top=8)
            log(f"[{spec['name']}] {name} under the profiler: the card busy "
                f"{r['device']['busy_ms']:.1f} ms in {r['device']['kernels']} device "
                f"events, {r['device']['busy_share']:.3f} of the p50; top: "
                + "; ".join(f"{n[:50]} {ms_:.2f} ms" for n, ms_ in r["device"]["top"]))
        out[name] = r
        log(f"[{spec['name']}] {name}: p50 {r['p50_ms']:.3f} ms/call (kernel backend "
            f"{kernel_p50[k]:.3f} ms), n_keep {r['n_keep']} of {eng.n_blocks} blocks, "
            f"tile_computed_frac {r['tile_computed_frac']:.4f}, block_prune_frac "
            f"{r['block_prune_frac']:.4f}, tree_prune_frac {r['tree_prune_frac']:.4f}, "
            f"compaction {r['compaction_ms']:.3f} ms; launches {seen}")
    return out, engine


def gathered_entry(eng64, tree_eng, q64, phase8):
    """gathered_topk at the main path's operands (k = 10): the tree engine's
    own call (its kept blocks, sorted queries and seeds), timed alone,
    against pruned_topk's plain version over the same compacted operands,
    visit order and splits (check_topk, in compact positions).  Returns the
    kernels line's entry; its launches are phase 8's pruned_topk launches."""
    from repro_torch.kernels.cosine_topk import default_splits, pruned_topk_plain
    from repro_torch.kernels.leaf_gather import (best_first_tiles, compact_blocks,
                                                 gathered_topk)

    keep, gqn, gqp, gtau, gperm = kept_blocks(tree_eng, q64, 10)

    def gather_call():
        return gathered_topk(eng64.index, keep, gqn, gqp, gtau, k=10, bm=tree_eng.bm,
                             margin=tree_eng.margin, row_out=gperm)

    got = gather_call()
    db_c, valid_c, lo_c, hi_c, _ = compact_blocks(eng64.index, keep)
    n_c, nk, bs_ = valid_c.numel(), keep.numel(), eng64.index.block_size
    # the visit order from block_bounds, which phase 5b holds to its plain
    # version bit for bit; the plain route here is pruned_topk's
    order = best_first_tiles(gqp, lo_c, hi_c, tree_eng.bm)
    g_args = (gqn, db_c, gqp, lo_c, hi_c, n_c)
    g_kw = dict(tau_init=gtau, block_order=order, row_valid=valid_c, k=10,
                bm=tree_eng.bm, bn=bs_, margin=tree_eng.margin,
                splits=default_splits(gqn.shape[0], n_c, gqn.shape[1], gqp.shape[1],
                                      bm=tree_eng.bm, bn=bs_, device=gqn.device),
                row_out=gperm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pruned_topk_plain(*g_args, **g_kw)
    torch.cuda.synchronize()
    g_plain_ms = (time.perf_counter() - t0) * 1e3
    # gathered_topk's padded-db positions back to compact ones, the plain
    # version's (every returned block is a kept one)
    pos = got[1].long()
    compact = torch.searchsorted(keep.long(), (pos // bs_).clamp(min=0)) * bs_ + pos % bs_
    got = (got[0], torch.where(pos >= 0, compact, -1).int(), got[2], got[3])
    g_r = check_topk(got, want, g_args, g_kw, 1e-5, pruned_topk_plain)
    check(topk_ok(g_r, 1e-5), f"gathered_topk differs from its plain route: {g_r}")
    g_ms = cuda_ms(gather_call, REPS)
    g_nbytes, g_ops = pruned_topk_costs(g_args, g_kw, got[2])
    comp_bytes = 2 * (db_c.numel() * 4 + valid_c.numel() + 2 * lo_c.numel() * 4)
    g_lib = []
    for s0 in range(0, gqn.shape[0], 2000):
        qc = gqn[s0:s0 + 2000]
        g_lib += cuda_ms(lambda: torch.topk(
            (qc @ db_c.T).masked_fill_(~valid_c[None, :], float("-inf")), 10, dim=1), 1)
    del got, want, db_c, valid_c, lo_c, hi_c
    gather_launches = sum(r["launches"]["pruned_topk"] for part in phase8.values()
                          for r in part.values())
    gather_entry = {
        "name": "gathered_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/leaf_gather.py",
        "replaces": "src/repro/kernels/leaf_gather.py:43",
        "launches": gather_launches, "max_abs_err": g_r["max_abs_err"],
        "ms": float(np.median(g_ms)), "plain_ms": g_plain_ms,
        **bound_entry(g_nbytes + comp_bytes, g_ops),
        "library_ms": float(sum(g_lib)),
        "library": "torch.matmul + torch.topk over the same queries and the kept rows, "
                   "5 calls of 2,000 queries",
        "path": "no kernel of its own: the compaction's gathers, block_bounds for the "
                "kept tiles' order and one pruned_topk launch; launches counts those "
                "pruned_topk launches of phase 8's tree calls",
        "n_keep": nk, "n_blocks": eng64.n_blocks, "ids_equal": g_r["ids_equal"],
        "computed_flips": g_r["computed_flips"],
        "flips_unexplained": g_r["flips_unexplained"], "ms_all": g_ms}
    log(f"[kernels] gathered_topk at the main path's operands (k = 10, {nk} of "
        f"{eng64.n_blocks} blocks kept): {gather_entry['ms']:.3f} ms, plain route "
        f"{g_plain_ms:.1f} ms, bound {gather_entry['bound_ms']:.3f} ms "
        f"({gather_entry['bound_by']}), matmul+topk {gather_entry['library_ms']:.3f} ms; "
        f"against the plain route {g_r}")
    return gather_entry


def planted_queries(index, seed):
    """NEAR_PM1_REPEATS queries per (pivot, similarity of NEAR_PM1), each at
    that float64 cosine to the pivot, float32 (numpy)."""
    rng = np.random.default_rng(seed)
    return np.array([at_cosine(rng, p, c) for p in unit_pivots(index) for c in NEAR_PM1
                     for _ in range(NEAR_PM1_REPEATS)], dtype=np.float32)


def unit_pivots(index):
    """The index's pivots, normalized again in float64 (numpy)."""
    piv = index.pivots.double().cpu().numpy()
    return piv / np.linalg.norm(piv, axis=1, keepdims=True)


def at_cosine(rng, p, c):
    """A unit vector (float64) at cosine ``c`` to the unit vector ``p``."""
    v = rng.standard_normal(p.shape)
    v -= (v @ p) * p
    v /= np.linalg.norm(v)
    return c * p + np.sqrt(max(0.0, 1 - c * c)) * v


def bound_soundness(idx, tree, q, label):
    """block_bounds over every block's and every tree node's sound interval
    for the queries ``q`` on the card, bit for bit with the plain version,
    plus the margin at least the float64 maximum similarity of the valid
    rows below each (fails otherwise); returns {"blocks": ..., "tree_nodes":
    ...} with the pairs, those short and the least slack.  ``tree=None``:
    the blocks only."""
    from repro_torch.kernels.bound_prune import block_bounds, block_bounds_plain
    from repro_torch.search import backends as bk

    qn, qp = bk.prep_queries(idx, q)
    nb, bs = idx.n_blocks, idx.block_size
    # float64 maxima per block, then up the tree
    best = []
    db64 = idx.db.double()
    for s in range(0, q.shape[0], 32):
        sims = (qn[s:s + 32].double() @ db64.T).masked_fill(~idx.valid[None, :],
                                                            float("-inf"))
        best.append(sims.view(-1, nb, bs).amax(2))
    del db64, sims
    best = torch.cat(best)
    parts = [("blocks", idx.dp_lo, idx.dp_hi, best)]
    if tree is not None:
        nl = tree.n_leaf_slots
        nodes = torch.full((q.shape[0], 2 * nl), float("-inf"), dtype=torch.float64,
                           device=q.device)
        nodes[:, nl:nl + nb] = best
        sz = nl // 2
        while sz >= 1:
            nodes[:, sz:2 * sz] = nodes[:, 2 * sz:4 * sz].view(-1, sz, 2).amax(2)
            sz //= 2
        parts.append(("tree_nodes", tree.node_lo, tree.node_hi, nodes))
    out = {}
    for what, lo, hi, want in parts:
        ub = block_bounds(qp, lo, hi)
        equal = bounds_equal(ub, block_bounds_plain(qp, lo, hi))
        slack = (ub.double() + 4e-7 - want)
        fin = torch.isfinite(want)
        if what == "tree_nodes":
            fin[:, 0] = False
        short = int((slack[fin] < 0).sum())
        out[what] = {"pairs": int(fin.sum()), "short": short, "equal_to_plain": equal,
                     "least_slack": float(slack[fin].min())}
        log(f"[{label}] {what}: {out[what]['pairs']} (query, {what}) pairs, bound + "
            f"margin below the float64 maximum in {short}, least slack "
            f"{out[what]['least_slack']:.3e}; block_bounds equal to its plain "
            f"version bit for bit: {equal}")
        check(short == 0 and equal, f"{label}: the bound over the {what} is short "
                                    f"or differs from its plain version")
        del ub, slack
    return out


def phase_near_pm1(eng, seed, kernels):
    """Phase 9 on ``eng``'s index: planted_queries; bound_soundness over the
    blocks and the tree nodes; then the kernel, scan and tree engines (both
    leaf stages) against the brute force at k = 10."""
    from repro_torch.core.index import search_brute
    from repro_torch.search import SearchEngine
    from repro_torch.search.tree import build_tree

    idx = eng.index
    q = torch.from_numpy(planted_queries(idx, seed)).cuda()
    out = {"queries": int(q.shape[0]), "similarities": list(NEAR_PM1),
           **bound_soundness(idx, build_tree(idx), q, "near +-1")}
    k = 10
    s_b, i_b = search_brute(idx, q, k)
    brute = {k: (s_b.cpu().numpy(), i_b.cpu().numpy())}
    spec = dict(CLUSTERED64, name="clustered-64, queries planted near +-1",
                m=int(q.shape[0]))
    for name, engine in (("kernel", SearchEngine(idx, backend="kernel")),
                         ("scan", SearchEngine(idx, backend="scan")),
                         ("tree_kernel", SearchEngine(idx, backend="tree", leaf_eval="kernel")),
                         ("tree_scan", SearchEngine(idx, backend="tree", leaf_eval="scan"))):
        sims, ids, st = engine.search(q, k)
        err, _ = exactness(spec, name, k, sims, ids, brute)
        out[name] = {"max_abs_err_vs_brute": err,
                     "block_prune_frac": float(st.block_prune_frac)}
    return out


class LiveRows:
    """The brute force's own copy of the corpus during phase 10 and 11: every
    row by external id (the stored rows of phase 3's index, then each
    insert normalized as the handle stores it) and which ids are live."""

    def __init__(self, index, capacity):
        valid = index.valid
        n = int(valid.sum())
        self.rows = index.db.new_zeros((capacity, index.db.shape[-1]))
        self.rows[index.row_ids[valid].long()] = index.db[valid]
        self.alive = torch.zeros(capacity, dtype=torch.bool, device=index.device)
        self.alive[:n] = True
        self.next_id = n

    def insert(self, ids, rows):
        r64 = np.asarray(rows, np.float64)
        r64 /= np.linalg.norm(r64, axis=1, keepdims=True)
        ids_t = torch.tensor(ids, device=self.rows.device)
        self.rows[ids_t] = torch.from_numpy(r64.astype(np.float32)).to(self.rows.device)
        self.alive[ids_t] = True
        self.next_id = max(self.next_id, max(ids) + 1)

    def delete(self, ids):
        self.alive[torch.tensor(ids, device=self.rows.device)] = False

    def live_ids(self):
        return torch.nonzero(self.alive)[:, 0].cpu().numpy()

    def matches(self, q, sims, ids, k, tol=1e-5):
        """The reference's online_matches_brute rule (benchmarks/latency.py)
        on the card: finite sims of shape [m, k], each within ``tol`` of the
        brute force's sorted k best over exactly the live rows, and every
        returned id live with its true similarity within ``tol``.  Returns
        (ok, max |sim - brute|, max |sim - true sim of its id|)."""
        dev = self.rows.device
        qn = torch.nn.functional.normalize(torch.as_tensor(q, device=dev).float(), dim=1)
        rows = self.rows[: self.next_id]
        alive = self.alive[: self.next_id]
        want = []
        for s0 in range(0, qn.shape[0], 1000):
            sc = (qn[s0:s0 + 1000] @ rows.T).masked_fill_(~alive[None, :], float("-inf"))
            want.append(torch.topk(sc, k, dim=1).values)
            del sc
        want = torch.cat(want)
        sims, ids = torch.as_tensor(sims, device=dev), torch.as_tensor(ids, device=dev)
        idl = ids.long()
        live = (idl >= 0) & (idl < self.next_id) & alive[idl.clamp(0, self.next_id - 1)]
        true = (qn[:, None, :] * rows[idl.clamp(0, self.next_id - 1)]).sum(-1)
        err_b = float((sims - want).abs().max())
        err_t = float((sims - true).abs().max())
        ok = (tuple(sims.shape) == (qn.shape[0], k) and bool(torch.isfinite(sims).all())
              and bool(live.all()) and err_b <= tol and err_t <= tol)
        return ok, err_b, err_t


#: mutation steps of phase 10a (the reference's serve loop,
#: benchmarks/latency.py): rows inserted, ids deleted, queries searched
ONLINE_STEPS, ONLINE_INSERT, ONLINE_DELETE, ONLINE_QUERIES = 12, 16, 4, 32
#: phase 10b's tombstones: the top-1 id of each of this many phase-3 queries
ONLINE_TOMBSTONE_QUERIES = 1000
#: phase 10b2's shape-stable insert of rows planted near +-1 under the live
#: tree, and phase 10c's insert with how many of its rows are planted there
ONLINE_PLANTED_WIDE = 64
ONLINE_GROW, ONLINE_PLANTED = 10_000, 100
ONLINE_PLANTED_AT = (1 - 1e-5, 1.0, -(1 - 1e-5), -1.0)


def phase_online(eng64, q64, brute64, seed, planted_seed, kernels, fresh_prune):
    """Phase 10: online mutation at full size over phase 3's index, through
    a ``kernel`` engine and a ``tree`` engine (kernel leaf stage) made on
    it, each with its own handle (which copies the index it mutates; phase
    3's index must come out untouched), through the same operations:

    a. ONLINE_STEPS steps of {insert ONLINE_INSERT mixture rows, delete
       ONLINE_DELETE live ids, search ONLINE_QUERIES fresh queries}; after
       the first insert the widened tree equals build_tree bit for bit, and
       block_bounds on it equals its plain version;
    b. tombstones: delete the top-1 id of each of the first
       ONLINE_TOMBSTONE_QUERIES phase-3 queries, search those queries;
       b2. insert ONLINE_PLANTED_WIDE rows at float64 cosines
       ONLINE_PLANTED_AT to the pivots into the tombstones, under the live
       tree: phase 9's soundness check on the widened (not rebuilt) tree,
       then phase 9's planted queries;
    c. a shape-changing insert of ONLINE_GROW rows, the first ONLINE_PLANTED
       at float64 cosines ONLINE_PLANTED_AT to the pivots; then phase 9's
       soundness check on the grown index and the rebuilt tree, and phase
       9's planted queries;
    d. reoptimize, and as its control a fresh build over the same live
       rows without b2's and c's planted ones (same queries).

    ``seed`` is phase 3's (the mixture's centres), ``planted_seed`` phase 9's.

    Every search is held to LiveRows.matches; after a, b, c and d both
    engines also search the 10,000 phase-3 queries (block_prune_frac beside
    the fresh build's ``fresh_prune``).  Each checked call's launches are
    counted per engine.  Returns (report, the kernel engine, LiveRows)."""
    from repro_torch.search import SearchEngine, build_tree
    from repro_torch.search.backends import _resolve_bn, prep_queries

    block_bounds, select, topk = kernels
    t_start = time.perf_counter()
    base = eng64.index
    base_before = {f: getattr(base, f).clone()
                   for f in ("valid", "row_ids", "dp_min", "dp_max", "dp_lo", "dp_hi")}
    engines = {"kernel": SearchEngine(base, backend="kernel"),
               "tree": SearchEngine(base, backend="tree")}
    live = LiveRows(base, base.db.shape[0] + 20_000)
    rng = np.random.default_rng(seed + 6)
    centres = mixture_centres(CLUSTERED64, seed)
    out = {"steps": [], "mutation_s": {name: {"insert": [], "delete": [], "reoptimize": []}
                                       for name in engines},
           "launches": {name: {kern.__name__: 0 for kern in kernels} for name in engines}}
    handles = {}
    for name, eng in engines.items():
        eng.search(q64[:ONLINE_QUERIES], 10)             # the tree builds here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles[name] = eng.online(auto_reoptimize=False)
        out.setdefault("handle_s", {})[name] = time.perf_counter() - t0
        check(eng.index is not base, f"the {name} engine's handle did not copy the index")
    log(f"[online] two engines over phase 3's index, each handle on its own copy "
        f"({base.n_blocks} blocks, "
        f"{len(handles['kernel']._free)} free slots); handles made in "
        f"{out['handle_s']['kernel']:.3f} / {out['handle_s']['tree']:.3f} s")

    def mutate(op, *arg):
        got = {}
        for name, h in handles.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = getattr(h, op)(*arg)
            torch.cuda.synchronize()
            out["mutation_s"][name][op].append(time.perf_counter() - t0)
        check(got["kernel"] == got["tree"], "the two handles minted different ids")
        if op == "reoptimize":
            return None
        if op == "insert":
            live.insert(got["kernel"], arg[0])
        else:
            live.delete(arg[0])
        same = all(torch.equal(a, b) for a, b in zip(engines["kernel"].index,
                                                      engines["tree"].index)
                   if a is not None)
        check(same, f"the two engines' indexes differ after {op}")
        return got["kernel"]

    def search(label, q, reps=3):
        rows = {}
        for name, eng in engines.items():
            for kern in kernels:
                kern.launches = 0
            sims, ids, st = eng.search(q, 10)
            torch.cuda.synchronize()
            seen = {kern.__name__: kern.launches for kern in kernels}
            for key, v in seen.items():
                out["launches"][name][key] += v
            if name == "kernel":
                want = {block_bounds.__name__: 0, select.__name__: 1, topk.__name__: 1}
                bn = _resolve_bn(eng.index, eng.bn)
            else:
                levels = st.extras["tree_levels"]
                want = {block_bounds.__name__: levels + 1, select.__name__: 0,
                        topk.__name__: 1}
                bn = eng.index.block_size
            check(seen == want, f"[online {label}] {name}: launches {seen}, want {want}")
            ok, err_b, err_t = live.matches(q, sims, ids, 10)
            check(ok, f"[online {label}] {name}: not the brute force over the live rows "
                      f"(max |sim - brute| {err_b:.3e}, |sim - true| {err_t:.3e})")
            del sims, ids
            ms = cuda_ms(lambda: eng.search(q, 10), reps)
            for kern in kernels:
                out["launches"][name][kern.__name__] += kern.launches - seen[kern.__name__]
            rows[name] = {"p50_ms": float(np.median(ms)), "ms": ms, "bn": bn,
                          "block_prune_frac": float(st.block_prune_frac),
                          "tile_computed_frac": float(st.tile_computed_frac),
                          "generation": st.generation, "decay_estimate": st.decay_estimate,
                          "n_blocks": eng.n_blocks, "index_epoch": eng.index_epoch,
                          "max_err_vs_brute": err_b, "launches": seen}
        fresh = (f" (fresh build, same queries: {fresh_prune:.4f})"
                 if q.shape[0] == q64.shape[0] else "")
        for name, r in rows.items():
            log(f"[online {label}] {name}: {q.shape[0]} queries, brute force over the live "
                f"rows matched (max |diff| {r['max_err_vs_brute']:.2e}); p50 "
                f"{r['p50_ms']:.3f} ms of {len(r['ms'])}, bn {r['bn']}, block_prune_frac "
                f"{r['block_prune_frac']:.4f}{fresh}, tile_computed_frac "
                f"{r['tile_computed_frac']:.4f}, generation {r['generation']}, "
                f"decay_estimate {r['decay_estimate']:.3e}, {r['n_blocks']} blocks, epoch "
                f"{r['index_epoch']}")
        out["steps"].append({"step": label, **rows})
        return rows

    # a. the reference's serve loop
    t_a = time.perf_counter()
    for step in range(1, ONLINE_STEPS + 1):
        new = mixture_draw(rng, centres, ONLINE_INSERT, CLUSTERED64["noise"])
        mutate("insert", new)
        if step == 1:
            tree = engines["tree"]._tree_index
            rebuilt = build_tree(engines["tree"].index)
            equal = all(torch.equal(a, b) for a, b in zip(tree[1:], rebuilt[1:]))
            qp = prep_queries(engines["tree"].index, q64[:ONLINE_QUERIES])[1]
            from repro_torch.kernels.bound_prune import block_bounds_plain
            nodes_equal = bounds_equal(block_bounds(qp, tree.node_lo, tree.node_hi),
                                       block_bounds_plain(qp, tree.node_lo, tree.node_hi))
            out["widened_tree"] = {"equal_to_build_tree": equal,
                                   "block_bounds_equal_to_plain": nodes_equal,
                                   "nodes": int(tree.node_valid.shape[0])}
            log(f"[online a1] the widened tree equals build_tree of the new index bit for "
                f"bit (node_lo, node_hi, node_valid): {equal}; block_bounds on its "
                f"{tree.node_valid.shape[0]} nodes equal to its plain version: {nodes_equal}")
            check(equal and nodes_equal, "the widened tree differs from build_tree")
            del tree, rebuilt
        ids = live.live_ids()
        mutate("delete", [int(x) for x in rng.choice(ids, ONLINE_DELETE, replace=False)])
        q = torch.from_numpy(mixture_draw(rng, centres, ONLINE_QUERIES,
                                          CLUSTERED64["noise"])).to(q64.device)
        search(f"a{step}", q)
    out["serve_loop_s"] = time.perf_counter() - t_a
    search("a_end_10000", q64, reps=1)

    # b. tombstones in old blocks
    alive = live.alive.cpu().numpy()
    top1 = [int(i) for i in np.unique(brute64[10][1][:ONLINE_TOMBSTONE_QUERIES, 0])
            if alive[i]]
    mutate("delete", top1)
    out["tombstones"] = len(top1)
    search("b", q64[:ONLINE_TOMBSTONE_QUERIES])
    search("b_10000", q64, reps=1)

    # b2. rows planted near +-1 into the tombstones, under the live tree
    tree_eng = engines["tree"]
    epoch = tree_eng.index_epoch
    check(tree_eng._tree_index is not None, "no live tree before step b2's insert")
    piv = unit_pivots(engines["kernel"].index)
    planted = np.array([at_cosine(rng, piv[i % len(piv)],
                                  ONLINE_PLANTED_AT[(i // len(piv)) % len(ONLINE_PLANTED_AT)])
                        for i in range(ONLINE_PLANTED_WIDE)], np.float32)
    planted_ids = mutate("insert", planted)
    check(tree_eng.index_epoch == epoch and tree_eng._tree_index is not None,
          "step b2's insert changed the shape or dropped the tree")
    qpl = torch.from_numpy(planted_queries(tree_eng.index, planted_seed)).to(q64.device)
    log(f"[online b2] {ONLINE_PLANTED_WIDE} rows at float64 cosines {ONLINE_PLANTED_AT} "
        f"to the pivots inserted into free slots under the live tree (no shape change); "
        f"phase 9's check on the widened node tables:")
    out["soundness_widened_tree"] = bound_soundness(tree_eng.index, tree_eng._tree_index,
                                                    qpl, "online b2")
    search("b2_planted", qpl)

    # c. a shape-changing insert, planted rows first (into the tombstones)
    planted = np.array([at_cosine(rng, piv[i % len(piv)],
                                  ONLINE_PLANTED_AT[(i // len(piv)) % len(ONLINE_PLANTED_AT)])
                        for i in range(ONLINE_PLANTED)], np.float32)
    grow = np.concatenate([planted, mixture_draw(rng, centres, ONLINE_GROW - ONLINE_PLANTED,
                                                 CLUSTERED64["noise"])])
    free = len(handles["kernel"]._free)
    blocks0 = engines["kernel"].n_blocks
    planted_ids += mutate("insert", grow)[:ONLINE_PLANTED]
    out["grow"] = {"rows": ONLINE_GROW, "into_free_slots": free,
                   "appended_blocks": engines["kernel"].n_blocks - blocks0}
    log(f"[online c] {ONLINE_GROW} rows inserted: {free} into free slots, "
        f"{out['grow']['appended_blocks']} blocks appended ({engines['kernel'].n_blocks} now)")
    search("c_10000", q64, reps=1)                      # the tree rebuilds here
    out["soundness"] = bound_soundness(engines["kernel"].index, engines["tree"]._tree_index,
                                       qpl, "online c")
    search("c_planted", qpl)

    # d. reoptimize; its maxmin pivots may land on b2's and c's planted rows, which
    # lie at +-1 and next to it from the old pivots
    mutate("reoptimize")
    out["reoptimize_s"] = {name: v["reoptimize"][0] for name, v in out["mutation_s"].items()}
    near = np.abs(unit_pivots(engines["kernel"].index) @ piv.T).max(1)
    out["reoptimize_pivots_within_1e-4_of_an_old_pivot_or_its_antipode"] = int(
        (near > 1 - 1e-4).sum())
    log(f"[online d] reoptimize: {out['reoptimize_s']['kernel']:.3f} s (kernel engine), "
        f"{out['reoptimize_s']['tree']:.3f} s (tree engine); of its {len(near)} new pivots "
        f"{int((near > 1 - 1e-4).sum())} lie within 1e-4 of an old pivot or its antipode")
    search("d_10000", q64, reps=3)
    # the control: a fresh build over the same live rows without b2's and
    # c's planted ones, searched with the same queries
    ids = np.setdiff1d(live.live_ids(), planted_ids)
    ctrl = SearchEngine.build(live.rows[torch.from_numpy(ids).to(live.rows.device)],
                              n_pivots=16, block_size=128)
    ctrl_prune = float(ctrl.search(q64, 10)[2].block_prune_frac)
    out["reoptimize_control"] = {"rows": int(len(ids)), "block_prune_frac": ctrl_prune}
    log(f"[online d] the control, a fresh build over the {len(ids)} live rows without the "
        f"{len(planted_ids)} planted ones: block_prune_frac {ctrl_prune:.4f} on the same "
        f"{q64.shape[0]} queries")
    del ctrl

    a_steps = [r for r in out["steps"] if r["step"] in {f"a{i}" for i in range(1, 13)}]
    med, qps = {}, {}
    for name, ops in out["mutation_s"].items():
        ins, dl = ops["insert"][:ONLINE_STEPS], ops["delete"][:ONLINE_STEPS]
        med[name] = {"insert": float(np.median(ins)) * 1e6,
                     "delete": float(np.median(dl)) * 1e6,
                     "tombstone_delete": ops["delete"][ONLINE_STEPS] * 1e6,
                     "planted_insert": ops["insert"][ONLINE_STEPS] * 1e6,
                     "grow_insert": ops["insert"][ONLINE_STEPS + 1] * 1e6}
        qps[name] = float(np.median([ONLINE_QUERIES / (i + d + r[name]["p50_ms"] / 1e3)
                                     for i, d, r in zip(ins, dl, a_steps)]))
    out.update(mutation_us=med, sustained_qps=qps, online_matches_brute=1.0,
               seconds=time.perf_counter() - t_start)
    for name in med:
        log(f"[online] {name} engine: step a's insert of {ONLINE_INSERT} rows "
            f"{med[name]['insert']:.0f} us, delete of {ONLINE_DELETE} ids "
            f"{med[name]['delete']:.0f} us per call (median of {ONLINE_STEPS}, "
            f"CUDA-synchronised); b's delete of {len(top1)} ids "
            f"{med[name]['tombstone_delete']:.0f} us; b2's insert of {ONLINE_PLANTED_WIDE} "
            f"rows {med[name]['planted_insert']:.0f} us; c's insert of {ONLINE_GROW} rows "
            f"{med[name]['grow_insert']:.0f} us; serve loop sustained {qps[name]:.1f} QPS "
            f"({ONLINE_QUERIES} queries / (insert + delete + search p50), median over "
            f"the steps); launches {out['launches'][name]}")
    log(f"[online] online_matches_brute 1.0: both engines matched the brute force over "
        f"the live rows after every step; phase 10 took {out['seconds']:.1f} s")
    untouched = all(torch.equal(getattr(base, f), v) for f, v in base_before.items())
    out["shared_index_untouched"] = untouched
    log(f"[online] phase 3's index, which both engines were made on, is untouched "
        f"({', '.join(base_before)} equal to before): {untouched}")
    check(untouched, "mutating phase 10's engines changed phase 3's index")
    kernel_eng = engines.pop("kernel")
    del engines
    return out, kernel_eng, live


#: phase 11's serving traffic, kNN-LM decoding (Khandelwal et al., ICLR
#: 2020): each generated token of a sequence queries the datastore once.
#: DECODE_SEQUENCES sequences decode at once as closed-loop clients of one
#: ContinuousBatcher (each sends its next query when its answer returns),
#: DECODE_TOKENS tokens each; half-way the store takes an insert of
#: SERVE_INSERT rows and a delete of SERVE_DELETE ids through batcher.run
DECODE_SEQUENCES, DECODE_TOKENS = (1, 8, 64), 64
SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS, SERVE_INSERT, SERVE_DELETE = 128, 2.0, 64, 16
#: pruned_topk's fused merge is timed at one query tile of each of these
MERGE_TILE_ROWS = (128, 32)
#: phase 11's kNN-LM datastore: GPT-2's vocabulary, the queries of one
#: knn_probs batch, the pairs added and the ids deleted
KNN_VOCAB, KNN_QUERIES, KNN_ADD, KNN_DELETE = 50_257, 128, 64, 16
#: phase 11's dedup corpus: documents, tokens each, planted near-duplicate
#: pairs (one token changed), embedding width
DEDUP_DOCS, DEDUP_TOKENS, DEDUP_PAIRS, DEDUP_DIM = 100_000, 64, 2_000, 256


class Dispatched:
    """The engine as a phase-11 ContinuousBatcher sees it: records each
    microbatch's rows and tile_computed_frac; with ``pad_to`` it zero-pads
    each microbatch to that many rows before the search and slices the
    padding off after, as the reference's batcher pads."""

    def __init__(self, eng, pad_to=None):
        self.eng, self.pad_to = eng, pad_to
        self.rows, self.tile_computed = [], []

    def search(self, q, k):
        m = q.shape[0]
        if self.pad_to:
            q = np.concatenate([q, np.zeros((self.pad_to - m, q.shape[1]), q.dtype)])
        sims, ids, st = self.eng.search(q, k)
        self.rows.append(m)
        self.tile_computed.append(float(st.tile_computed_frac))
        return sims[:m], ids[:m], st


def search_alone(eng, q):
    """``eng.search`` of the ``[m, d]`` queries ``q`` as they are and
    zero-padded to SERVE_MAX_BATCH rows: p50 of REPS (CUDA events) and
    tile_computed_frac of each, and the card's busy time in one unpadded
    call under the profiler."""
    m = q.shape[0]
    qt = torch.from_numpy(q).to(eng.device)
    r = {"rows": m}
    for name, x in (("unpadded", qt),
                    ("padded", torch.cat([qt, qt.new_zeros(SERVE_MAX_BATCH - m, q.shape[1])]))):
        st = eng.search(x, 10)[2]
        ms = cuda_ms(lambda: eng.search(x, 10), REPS)
        r[name] = {"p50_ms": float(np.median(ms)), "ms": ms,
                   "tile_computed_frac": float(st.tile_computed_frac)}
    r["unpadded"]["device"] = device_busy(lambda: eng.search(qt, 10),
                                          r["unpadded"]["p50_ms"], top=6)
    busy = r["unpadded"]["device"]
    log(f"[serve] the search alone at {m} rows: p50 {r['unpadded']['p50_ms']:.3f} ms, "
        f"tile_computed_frac {r['unpadded']['tile_computed_frac']:.4f}; zero-padded to "
        f"{SERVE_MAX_BATCH} rows {r['padded']['p50_ms']:.3f} ms, tile_computed_frac "
        f"{r['padded']['tile_computed_frac']:.4f} (p50 of {REPS}, CUDA events); one "
        f"unpadded call kept the card busy {busy['busy_ms']:.3f} ms in {busy['kernels']} "
        f"device events, {busy['busy_share']:.3f} of its p50; top: "
        + "; ".join(f"{n[:40]} {ms_:.3f} ms" for n, ms_ in busy["top"]))
    return r


def decode_loop(eng, live, queries, new_rows, pad, rng):
    """kNN-LM decoding through one ContinuousBatcher over ``eng`` (k = 10,
    SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS): ``queries`` is ``[B, T, d]``, and
    sequence s, a closed-loop client, submits queries[s, t] once its answer
    to queries[s, t - 1] has come back.  After T // 2 tokens of every
    sequence, an insert of ``new_rows`` and a delete of SERVE_DELETE live
    ids go through ``batcher.run``.  Each half's answers are held to
    LiveRows.matches over the rows live then.  ``pad``: each microbatch is
    zero-padded to SERVE_MAX_BATCH rows (Dispatched).  Returns the report
    (latency per request on the host clock, occupancy, batches, QPS)."""
    import asyncio

    from repro_torch.serve import ContinuousBatcher

    b, t_all, d = queries.shape
    half = t_all // 2
    h = eng.online()
    dead = [int(x) for x in rng.choice(live.live_ids(), SERVE_DELETE, replace=False)]
    disp = Dispatched(eng, SERVE_MAX_BATCH if pad else None)
    batcher = ContinuousBatcher(disp, 10, max_batch=SERVE_MAX_BATCH,
                                max_wait_ms=SERVE_MAX_WAIT_MS)
    sims = np.zeros((b, t_all, 10), np.float32)
    ids = np.zeros((b, t_all, 10), np.int32)
    latency = []

    async def sequence(s, t0, t1):
        for t in range(t0, t1):
            start = time.perf_counter()
            sims[s, t], ids[s, t] = await batcher.submit(queries[s, t])
            latency.append(time.perf_counter() - start)

    async def tokens(t0, t1):
        start = time.perf_counter()
        await asyncio.gather(*(sequence(s, t0, t1) for s in range(b)))
        return time.perf_counter() - start

    async def main():
        try:
            w1 = await tokens(0, half)
            new_ids = await batcher.run(h.insert, new_rows)
            await batcher.run(h.delete, dead)
            return w1, new_ids, await tokens(half, t_all)
        finally:
            await batcher.close()

    w1, new_ids, w2 = asyncio.run(asyncio.wait_for(main(), timeout=600))
    what = f"{b} sequences x {t_all} tokens, {'padded' if pad else 'unpadded'}"
    errs = []
    for t0, t1 in ((0, half), (half, t_all)):
        if t0:
            live.insert(new_ids, new_rows)
            live.delete(dead)
        ok, err_b, err_t = live.matches(
            queries[:, t0:t1].reshape(-1, d), torch.from_numpy(sims[:, t0:t1].reshape(-1, 10)),
            torch.from_numpy(ids[:, t0:t1].reshape(-1, 10)), 10)
        check(ok, f"[serve {what}] an answer is not the brute force over the rows live "
                  f"when its batch ran ({err_b:.3e}, {err_t:.3e})")
        errs.append(err_b)
    lat = np.array(latency) * 1e3
    rows = np.array(disp.rows)
    n = b * t_all
    r = {"sequences": b, "tokens": t_all, "padded": pad, "requests": n,
         "latency_p50_ms": float(np.median(lat)),
         "latency_p99_ms": float(np.percentile(lat, 99)), "occupancy": batcher.occupancy,
         "batches": batcher.n_batches, "rows_per_batch_mean": float(rows.mean()),
         "rows_per_batch_max": int(rows.max()),
         "tile_computed_frac_mean": float(np.mean(disp.tile_computed)),
         "qps": n / (w1 + w2), "halves_s": [w1, w2], "max_err_vs_brute": max(errs)}
    log(f"[serve] kNN-LM decoding, {what} (closed loop, max_batch {SERVE_MAX_BATCH}, "
        f"max_wait {SERVE_MAX_WAIT_MS} ms; an insert of {len(new_rows)} rows and a delete of "
        f"{SERVE_DELETE} ids through run() half-way): {n} requests, every answer the brute "
        f"force over the rows live then (max |diff| {max(errs):.2e}); per request p50 "
        f"{r['latency_p50_ms']:.3f} ms, p99 {r['latency_p99_ms']:.3f} ms (host clock); "
        f"{r['batches']} batches of {r['rows_per_batch_mean']:.2f} rows on average (max "
        f"{r['rows_per_batch_max']}), occupancy {r['occupancy']:.4f}, tile_computed_frac "
        f"{r['tile_computed_frac_mean']:.4f} on average; {r['qps']:.1f} QPS")
    return r


def count_searches():
    """Counts every SearchEngine.search call by backend until the returned
    ``restore`` is called: (counter, restore)."""
    from repro_torch.search import SearchEngine

    calls = collections.Counter()
    search = SearchEngine.search

    def counted(self, *a, **kw):
        calls[self.backend_name] += 1
        return search(self, *a, **kw)

    SearchEngine.search = counted
    return calls, lambda: setattr(SearchEngine, "search", search)


def phase_serving(eng, live, eng64, q64, seed, mixture_seed, kernels):
    """Phase 11: single-device serving at full size, with every search call
    counted: each is a ``kernel`` engine's and launches ``pruned_topk`` and
    ``block_bounds_select`` (``kernels[0]``, ``kernels[1]``) once each and
    nothing else of ``kernels``.

    a. zero-padded rows: a padded batch's real rows equal an unpadded
       search, its padding rows finite;
    b. kNN-LM decoding (decode_loop) over ``eng`` (phase 10's reoptimized
       kernel engine) at each of DECODE_SEQUENCES sequences, unpadded and
       padded, beside search_alone at that many rows;
    c. KNNDatastore over ``eng64`` (phase 3's engine) with next tokens drawn
       from ``seed``: knn_probs of KNN_QUERIES queries against a plain torch
       computation over the brute force's neighbours, add_pairs, delete;
    d. find_near_duplicates on DEDUP_DOCS embed_tokens documents against a
       brute force on the card.

    ``mixture_seed`` is phase 3's (the mixture's centres)."""
    for kern in kernels:
        kern.launches = 0
    calls, restore = count_searches()
    try:
        out = serving_parts(eng, live, eng64, q64, seed, mixture_seed)
    finally:
        restore()
    out["search_calls"] = dict(calls)
    out["launches"] = {kern.__name__: kern.launches for kern in kernels}
    n = sum(calls.values())
    want = {kern.__name__: n if i < 2 else 0 for i, kern in enumerate(kernels)}
    log(f"[serve] phase 11: {n} search calls {dict(calls)}, launches {out['launches']} "
        f"(one pruned_topk and one block_bounds_select per call: "
        f"{out['launches'] == want})")
    check(set(calls) == {"kernel"} and out["launches"] == want,
          f"phase 11's launches {out['launches']} are not one pruned_topk and one "
          f"block_bounds_select per kernel-engine search call {dict(calls)}")
    return out


def serving_parts(eng, live, eng64, q64, seed, mixture_seed):
    """Parts a-d of phase_serving; returns their report."""
    from repro_torch.core.index import search_brute
    from repro_torch.data.dedup import embed_tokens, find_near_duplicates
    from repro_torch.serve import KNNDatastore

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    centres = mixture_centres(CLUSTERED64, mixture_seed)
    out = {}

    # a. padding rows
    q_np = q64.cpu().numpy()
    real = q64[:100]
    s_r, i_r, _ = eng.search(real, 10)
    s_p, i_p, _ = eng.search(torch.cat([real, real.new_zeros(28, real.shape[1])]), 10)
    pad_ok = (bool(torch.isfinite(s_p).all())
              and bool(torch.allclose(s_p[:100], s_r, atol=1e-6, rtol=0))
              and torch.equal(torch.sort(i_p[:100], 1).values, torch.sort(i_r, 1).values))
    log(f"[serve] a batch of 100 queries zero-padded to 128: real rows equal to the "
        f"unpadded search and every padding row finite (no NaN): {pad_ok}")
    check(pad_ok, "padding rows changed real rows' results or produced NaN")
    out["padding_rows_ok"] = pad_ok

    # b. kNN-LM decoding through the continuous batcher
    out["decode"] = []
    start = 0
    for b in DECODE_SEQUENCES:
        qs = q_np[start:start + b * DECODE_TOKENS].reshape(b, DECODE_TOKENS, -1)
        start += b * DECODE_TOKENS
        alone = search_alone(eng, qs[:, 0])
        for pad in (False, True):
            r = decode_loop(eng, live, qs, mixture_draw(rng, centres, SERVE_INSERT,
                                                        CLUSTERED64["noise"]), pad, rng)
            out["decode"].append(dict(r, search_alone=alone))

    # c. the kNN-LM datastore
    n0 = eng64.n_valid
    values = np.random.default_rng(seed + 1).integers(0, KNN_VOCAB, n0)
    ds = KNNDatastore(eng64, values, KNN_VOCAB, k=16)
    hq = q64[:KNN_QUERIES]
    probs = ds.knn_probs(hq)
    s_g, _, got_i = ds.lookup(hq)
    s_b, i_b = search_brute(eng64.index, hq, ds.k)
    w = torch.softmax(ds.temp * s_b, dim=-1)
    plain = torch.zeros_like(probs).scatter_add_(1, ds.values[i_b.long()].long(), w)
    same = (torch.sort(got_i, 1).values == torch.sort(i_b, 1).values).all(1)
    near_ties = tie_aware_mismatches(s_g.cpu().numpy(), got_i.cpu().numpy(),
                                     s_b.cpu().numpy(), i_b.cpu().numpy(), 1e-5)
    err = float((probs - plain)[same].abs().max())
    knn = {"queries": KNN_QUERIES, "k": ds.k, "vocab": KNN_VOCAB, "max_abs_err": err,
           "rows_with_other_neighbours": int((~same).sum())}
    log(f"[serve] KNNDatastore knn_probs of {KNN_QUERIES} queries (k = {ds.k}, vocab "
        f"{KNN_VOCAB}) against softmax + scatter_add over the brute force's neighbours: "
        f"max |diff| {err:.3e} over the {int(same.sum())} rows whose neighbour sets equal "
        f"(the rest differ by near-ties only: {near_ties == 0})")
    check(err <= 1e-6 and near_ties == 0, "knn_probs differs from its plain computation")
    emb = mixture_draw(rng, centres, KNN_ADD, CLUSTERED64["noise"])
    toks = rng.integers(0, KNN_VOCAB, KNN_ADD)
    ids = ds.add_pairs(emb, toks)
    _, t_add, i_add = ds.lookup(emb)
    own = (bool((i_add[:, 0].cpu() == torch.tensor(ids)).all())
           and bool((t_add[:, 0].cpu() == torch.from_numpy(toks)).all()))
    dead = ids[:KNN_DELETE // 2] + [int(x) for x in
                                     np.unique(i_b[:, 0].cpu().numpy())[:KNN_DELETE // 2]]
    ds.delete(dead)
    _, _, i_after = ds.lookup(torch.cat([hq, torch.from_numpy(emb).to(hq.device)]))
    gone = not bool(torch.isin(i_after, torch.tensor(dead, device=hq.device)).any())
    knn.update(add_pairs_top1_own=own, deleted_never_return=gone)
    log(f"[serve] KNNDatastore add_pairs of {KNN_ADD}: each lookup's top-1 is its own id "
        f"and token: {own}; delete of {len(dead)} ids: none returned after: {gone}")
    check(own and gone, "add_pairs or delete of the datastore misbehaved")
    out["knn"] = knn

    # d. dedup
    drng = np.random.default_rng(seed + 2)
    tokens = drng.integers(0, KNN_VOCAB, (DEDUP_DOCS, DEDUP_TOKENS))
    src = drng.choice(DEDUP_DOCS - DEDUP_PAIRS, DEDUP_PAIRS, replace=False)
    tokens[-DEDUP_PAIRS:] = tokens[src]
    tokens[-DEDUP_PAIRS:, 0] = drng.integers(0, KNN_VOCAB, DEDUP_PAIRS)
    t0 = time.perf_counter()
    embd = embed_tokens(tokens, dim=DEDUP_DIM)
    embed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs, stats = find_near_duplicates(embd, threshold=0.95, k=8)
    dedup_s = time.perf_counter() - t0
    want, edge = brute_pairs(torch.from_numpy(embd).to(q64.device), 0.95, 8)
    diff = set(pairs) ^ want
    planted = {(min(a, b), max(a, b)) for a, b in
               zip(src.tolist(), range(DEDUP_DOCS - DEDUP_PAIRS, DEDUP_DOCS))}
    out["dedup"] = {"docs": DEDUP_DOCS, "dim": DEDUP_DIM, "pairs": len(pairs),
                    "brute_pairs": len(want), "differ": len(diff),
                    "differ_beyond_threshold_ties": len(diff - edge),
                    "planted_found": len(planted & set(pairs)), "planted": DEDUP_PAIRS,
                    "block_prune_frac": float(stats.block_prune_frac),
                    "backend": stats.backend, "seconds": dedup_s, "embed_s": embed_s}
    log(f"[serve] find_near_duplicates on {DEDUP_DOCS} documents (dim {DEDUP_DIM}, "
        f"threshold 0.95, k = 8, backend {stats.backend}): {len(pairs)} pairs, the brute "
        f"force on the card {len(want)}, differing {len(diff)} (beyond scores within 1e-5 "
        f"of the threshold: {out['dedup']['differ_beyond_threshold_ties']}); "
        f"{out['dedup']['planted_found']} of {DEDUP_PAIRS} planted pairs found; "
        f"block_prune_frac {out['dedup']['block_prune_frac']:.4f}; {dedup_s:.3f} s "
        f"(build + search), embed_tokens {embed_s:.1f} s on the host")
    check(out["dedup"]["differ_beyond_threshold_ties"] == 0,
          "find_near_duplicates differs from the brute force")
    out["seconds"] = time.perf_counter() - t_start
    log(f"[serve] phase 11: {out['seconds']:.1f} s")
    return out


def brute_pairs(emb, threshold, k, chunk=2000):
    """find_near_duplicates' answer by a brute force on the card: the pairs
    (i < j) among each row's ``k`` nearest others (by torch.topk over the
    whole matrix of cosines) at ``threshold`` or above, and the pairs
    within 1e-5 of it, which may fall either way."""
    e = torch.nn.functional.normalize(emb.float(), dim=1)
    want, edge = set(), set()
    for s0 in range(0, e.shape[0], chunk):
        v, j = torch.topk(e[s0:s0 + chunk] @ e.T, k + 1, dim=1)
        v, j = v.cpu().numpy(), j.cpu().numpy()
        r = np.arange(s0, s0 + len(j))[:, None].repeat(k + 1, 1)
        hit = (j != r) & (v >= threshold)
        want |= {(min(a, b), max(a, b)) for a, b in zip(r[hit].tolist(), j[hit].tolist())}
        near = (j != r) & (np.abs(v - threshold) <= 1e-5)
        edge |= {(min(a, b), max(a, b)) for a, b in zip(r[near].tolist(), j[near].tolist())}
    return want, edge


#: phase 12, kNN-LM serving at full width (Khandelwal et al., ICLR 2020):
#: the launcher's default arch at full depth and width with random weights
#: from the seed (the repo has no weights); its datastore harvested by
#: KNNDatastore.from_corpus over CORPUS_SEQS synthetic sequences of
#: CORPUS_LEN tokens, CORPUS_BATCH per forward, built with the engine's
#: defaults; traffic: each of KNNLM_REQUESTS prompts of KNNLM_PROMPT tokens,
#: KNNLM_GEN greedy tokens, kNN off and on at the launcher's k and lambda
KNNLM_ARCH = "tinyllama-1.1b"
CORPUS_SEQS, CORPUS_LEN, CORPUS_BATCH = 512, 2048, 16
KNNLM_REQUESTS, KNNLM_PROMPT, KNNLM_GEN = (8, 64), 256, 32
KNNLM_K, KNNLM_LMBDA = 8, 0.25
#: bf16 logits (std about 1) of cache decode against teacher forcing: the
#: two run GEMMs of other shapes, whose bf16 outputs round apart, through
#: 22 layers (PERF.md section 6, PR 21)
KNNLM_LOGIT_ATOL = 0.25
#: phase 12d: pairs added through add_pairs; near-copies planted among the
#: hidden states that go to find_near_duplicates
KNNLM_ADD, KNNLM_DEDUP_PLANTED = 64, 256


#: phase 13, kNN-LM serving across the model families: each arch at full
#: width and depth with random weights from the seed, one at a time; its
#: store from from_corpus over FAMILY_SEQS synthetic sequences of
#: FAMILY_LEN tokens (or cfg.max_seq_len where that is smaller; a VLM's
#: sequences also carry its vision positions, which loss_offset cuts),
#: FAMILY_BATCH per forward, the engine's defaults; traffic as phase 12's.
#: mixtral-8x22b (141 B params) and qwen2-72b do not fit one card at fp32
FAMILY_ARCHS = ("granite-moe-1b-a400m", "zamba2-1.2b", "rwkv6-1.6b", "internvl2-1b",
                "whisper-small")
FAMILY_SEQS, FAMILY_LEN, FAMILY_BATCH = 128, 1024, 16
#: check b: cache decode against teacher forcing, max |logit diff| over the
#: teacher's logit std (bf16 activations: GEMMs of other shapes round
#: apart, as in phase 12, whose 22 layers gave 0.082 at std 1)
FAMILY_LOGIT_REL_ATOL = 0.25
#: check b for an MoE, whose routing is discontinuous: GEMMs of other shapes
#: give another top-k of the router at some (layer, position) pairs, and
#: such a position moves by a whole expert's share (max |logit diff| 3.39
#: at std 0.64 in bf16).  So the teacher's expert choices are replayed into
#: the cache path (moe_replay) and the two paths compared in bf16 within
#: this share of the teacher's logit std.  The honest gap is bf16 rounding
#: that grows with depth, alike on the card and the CPU: 0.095 / 0.146 /
#: 0.296 / 0.380 at 4 / 8 / 16 / 24 layers on the card, 0.403 at 24 on the
#: CPU, 0.485 with the old index_add_ combine; each bf16 path lies ~1.0 std
#: from the float32 computation (tools/moe_teacher_forcing.py, PERF.md
#: section 6) ...
FAMILY_MOE_BF16_REL_ATOL = 0.6
#: ... and in float32 activations (TF32 off) within this one (1.2e-4)
FAMILY_MOE_FP32_REL_ATOL = 1e-3
#: check c: the chunked and the recurrent form of one layer in float32 at
#: full width over one 256-token prompt: max |diff| over max |value| of the
#: outputs and of the final states (sums of 256 steps in other orders)
FAMILY_RECURRENT_RTOL = 1e-4


class LaunchTally:
    """Launch counts of ``kernels`` over a path driven in pieces: ``collect``
    adds the counts since the last zeroing to ``total`` and zeroes them;
    ``discard`` zeroes them without adding (launches that check the path
    rather than run it)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.total = collections.Counter({kern.__name__: 0 for kern in kernels})
        self.discard()

    def counts(self):
        return {kern.__name__: kern.launches for kern in self.kernels}

    def collect(self):
        self.total.update(self.counts())
        self.discard()

    def discard(self):
        for kern in self.kernels:
            kern.launches = 0


class RecordedStore:
    """The kNN-LM datastore as phase 12's Engine sees it.  Each decode
    step's ``interpolate`` (lookup, knn_probs, the mix) runs between two
    synchronizations on the host clock, with the launch counts zeroed
    before it and read after it; the engine's search inside it is timed
    alone the same way.  Each step keeps its queries, results, counts and
    stats for the checks."""

    def __init__(self, ds, tally):
        self.ds, self.tally, self.steps = ds, tally, []
        search = ds.engine.search

        def timed_search(q, k, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = search(q, k, **kw)
            torch.cuda.synchronize()
            self._search = (time.perf_counter() - t0, q, r)
            return r

        ds.engine.search = timed_search

    def close(self):
        del self.ds.engine.search

    def interpolate(self, hidden, lm_probs, lmbda):
        self.tally.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = self.ds.interpolate(hidden, lm_probs, lmbda)
        torch.cuda.synchronize()
        search_s, q, (sims, ids, st) = self._search
        self.steps.append({"s": time.perf_counter() - t0, "search_s": search_s, "q": q,
                           "sims": sims, "ids": ids, "launches": self.tally.counts(),
                           "block_prune_frac": float(st.block_prune_frac),
                           "tile_computed_frac": float(st.tile_computed_frac)})
        self.tally.collect()
        return probs


def gb(nbytes):
    return nbytes / 1e9


def decode_runs(fns, params, rec, tally, batches, card, tag, *, again=(), gen=KNNLM_GEN):
    """Each batch of prompts (``batches``: {B: batch}) prefilled and decoded
    ``gen`` greedy tokens through Engine, with kNN off and then on
    (``rec``, a RecordedStore), timed on the host clock between
    synchronizations; the kNN-off runs record every step's logits.  For
    each (B, kNN) in ``again`` the same prefilled cache is decoded a second
    time, and ``again_equal`` says whether it gave the same tokens.
    Returns {(B, kNN): (result, tokens, logits, steps, batch)}."""
    from repro_torch.serve.engine import Engine

    runs = {}
    for b, batch in batches.items():
        max_seq = fns.loss_offset(batch) + KNNLM_PROMPT + gen + 8
        for knn in (False, True):
            eng = Engine(fns, params, max_seq=max_seq, knn=rec if knn else None,
                         lmbda=KNNLM_LMBDA)
            logits = []
            if not knn:
                step = eng._decode_step

                def recording(*a, _step=step, _logits=logits):
                    hidden, lg, cache = _step(*a)
                    _logits.append(lg)
                    return hidden, lg, cache

                eng._decode_step = recording
            first = len(rec.steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, clen, _ = eng.prefill(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            toks, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], gen)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            steps = rec.steps[first:]
            r = {"requests": b, "knn": knn, "prefill_s": t1 - t0,
                 "prefill_tok_s": b * KNNLM_PROMPT / (t1 - t0), "decode_s": t2 - t1,
                 "decode_tok_s": b * gen / (t2 - t1),
                 "step_ms": (t2 - t1) / gen * 1e3}
            if not knn:
                # the wrapper closes over eng's own method: a cycle that would
                # keep the model alive until the garbage collector runs
                del eng._decode_step
            if (b, knn) in again:
                toks2, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], gen)
                r["again_equal"] = bool(torch.equal(toks, toks2))
            del cache
            if knn:
                knn_s = sum(st["s"] for st in steps)
                search_s = sum(st["search_s"] for st in steps)
                r.update(knn_ms_per_step=knn_s / gen * 1e3,
                         search_ms_per_step=search_s / gen * 1e3,
                         search_share=search_s / (t2 - t1),
                         model_ms_per_step=(t2 - t1 - knn_s) / gen * 1e3,
                         block_prune_frac=float(np.mean([st["block_prune_frac"]
                                                         for st in steps])),
                         tile_computed_frac=float(np.mean([st["tile_computed_frac"]
                                                           for st in steps])),
                         step_launches=[st["launches"] for st in steps])
            else:
                r["model_ms_per_step"] = r["step_ms"]
            tally.collect()
            runs[b, knn] = (r, toks, logits, steps, batch)
            log(f"{tag} B = {b}, kNN {'on' if knn else 'off'}: prefill "
                f"{r['prefill_tok_s']:.0f} tok/s ({r['prefill_s']:.3f} s), decode "
                f"{r['decode_tok_s']:.1f} tok/s ({r['step_ms']:.2f} ms a step"
                + (f"; the kNN lookup {r['knn_ms_per_step']:.2f} ms, its search "
                   f"{r['search_ms_per_step']:.2f} ms ({r['search_share']:.3f} of the step), "
                   f"the model {r['model_ms_per_step']:.2f} ms; block_prune_frac "
                   f"{r['block_prune_frac']:.4f}, tile_computed_frac "
                   f"{r['tile_computed_frac']:.4f}" if knn else "") + f"); {card}")
    return runs


def check_lookups(runs, idx, kernels, tag, gen=KNNLM_GEN):
    """Check a of phases 12 and 13: every kNN-on step's lookup against
    brute_topk over the store's keys (tie-aware within 1e-5), and one
    launch of each of kernels[:2] per step and none of the rest.  Fatal on
    failure; returns {B: what was found}."""
    path = tuple(kern.__name__ for kern in kernels[:2])
    want_step = {kern.__name__: int(kern.__name__ in path) for kern in kernels}
    n_keys = int(idx.valid.sum())
    exact = {}
    for (b, knn), (r, _, _, steps, _) in runs.items():
        if not knn:
            continue
        errs, bad = [], 0
        for st in steps:
            qn = torch.nn.functional.normalize(st["q"].float(), dim=1)
            s_b, p_b = brute_topk(qn, idx.db, KNNLM_K)
            s_b, i_b = s_b.cpu().numpy(), idx.row_ids[p_b].cpu().numpy()
            s_g, i_g = st["sims"].cpu().numpy(), st["ids"].cpu().numpy()
            check((i_g >= 0).all() and np.isfinite(s_g).all(), "a lookup returned padding")
            errs.append(float(np.abs(s_g - s_b).max()))
            bad += tie_aware_mismatches(s_g, i_g, s_b, i_b, 1e-5)
        launches_ok = all(st["launches"] == want_step for st in steps)
        exact[b] = {"steps": len(steps), "max_abs_err": max(errs), "rows_differing": bad,
                    "one_launch_each_per_step": launches_ok}
        log(f"{tag} B = {b}: {len(steps)} lookups of {b} queries against the brute "
            f"force over {n_keys} keys of width {idx.db.shape[1]}: max |sim diff| "
            f"{max(errs):.3e}, rows differing beyond near-ties {bad}; one "
            f"{' and one '.join(path)} launch per step and nothing else: {launches_ok}")
        check(max(errs) <= 1e-5 and bad == 0, f"{tag} B = {b}: a kNN lookup is not exact")
        check(len(steps) == gen and launches_ok,
              f"{tag} B = {b}: a decode step's lookup did not launch each of {path} once")
    return exact


def run_launcher(argv, cfg, tally, tag):
    """``repro_torch.launch.serve.main(argv)`` at full width: its tokens
    must be [8, 16] and its decode must launch each of the tally's first
    two kernels once a step.  Returns its seconds and launches."""
    from repro_torch.launch import serve as launch_serve

    path = tuple(kern.__name__ for kern in tally.kernels[:2])
    t0 = time.perf_counter()
    toks = launch_serve.main(argv)
    launched = tally.counts()
    r = {"s": time.perf_counter() - t0, "launches": launched}
    log(f"{tag} the launcher ({' '.join(argv)}): {r['s']:.1f} s, tokens "
        f"{tuple(toks.shape)}, launches {launched}")
    check(toks.shape == (8, 16) and int(toks.max()) < cfg.vocab
          and all(launched[name] == 16 for name in path),
          f"{tag} the launcher's decode did not search once per step")
    tally.collect()
    del toks
    torch.cuda.empty_cache()
    return r


def harvest_store(fns, params, batches, cfg, dev):
    """KNNDatastore.from_corpus over ``batches`` (the engine's defaults,
    k = KNNLM_K), the harvest and the build timed apart at from_pairs.
    Returns (store, harvest s, build s)."""
    from repro_torch.serve import KNNDatastore

    marks = {}
    real = KNNDatastore.__dict__["from_pairs"]

    def timed_pairs(cls, *a, **kw):
        torch.cuda.synchronize()
        marks["harvested"] = time.perf_counter()
        return real.__func__(cls, *a, **kw)

    KNNDatastore.from_pairs = classmethod(timed_pairs)
    try:
        t0 = time.perf_counter()
        ds = KNNDatastore.from_corpus(fns, params, batches, cfg.vocab, k=KNNLM_K, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        KNNDatastore.from_pairs = real
    return ds, marks["harvested"] - t0, t1 - marks["harvested"]


def phase_knnlm(seed, card, kernels):
    """Phase 12: kNN-LM serving through the port's model at full width.

    The launcher (``repro_torch.launch.serve.main``) at full width with its
    own defaults and the kernel backend; then ARCHS[KNNLM_ARCH] at full
    depth from ``seed``, its store from ``from_corpus``, and each of
    KNNLM_REQUESTS prompts decoded through ``Engine`` with kNN off and on
    (RecordedStore).  ``kernels``: pruned_topk and block_bounds_select,
    which each kNN lookup launches once, then kernels it must not launch.
    Checks, each fatal:

    a. every kNN-on step's lookup against brute_topk over the store's keys
       on the card (tie-aware), and one launch of each of kernels[:2] per
       step and none of the rest;
    b. B = KNNLM_REQUESTS[0], kNN off: every decode step's logits against
       lm_forward over the whole sequence without cache, within
       KNNLM_LOGIT_ATOL;
    c. bound_soundness (phase 9's) of one kNN-on step's 64 queries over
       every block at d = 2048;
    d. CUDA tensors straight into the entry points: the model's hidden
       states into from_corpus (the harvest), add_pairs (then a lookup that
       finds them), ContinuousBatcher.submit, and find_near_duplicates.

    The path's launches are counted over the launcher, the harvest and
    build, the decode runs and d; the checks' own launches are not."""
    import asyncio

    from repro_torch.configs import ARCHS
    from repro_torch.data.dedup import find_near_duplicates
    from repro_torch.models import lm, model_fns, synthetic_batch
    from repro_torch.serve.engine import Engine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    cfg = ARCHS[KNNLM_ARCH]
    fns = model_fns(cfg)
    tally = LaunchTally(kernels)
    path = tuple(kern.__name__ for kern in kernels[:2])
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "corpus": [CORPUS_SEQS, CORPUS_LEN], "card": card}

    # the launcher: full width, its own defaults, the kernel backend
    out["launcher"] = run_launcher(["--arch", KNNLM_ARCH, "--knn", "--search-backend",
                                    "kernel", "--device", str(dev)], cfg, tally, "[knn-lm]")

    # the model and the memory reckoned before the run
    params = fns.init(seed, device=dev)
    param_b = sum(p.numel() * p.element_size() for p in params.parameters())
    n_keys = CORPUS_SEQS * (CORPUS_LEN - 1)
    key_b = n_keys * cfg.d_model * 4
    log(f"[knn-lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype} activations, {cfg.param_dtype} params ({gb(param_b):.2f} GB); "
        f"reckoned: {n_keys} keys of width {cfg.d_model} take {gb(key_b):.2f} GB; the "
        f"build holds the keys, two float32 copies and one float64 copy at once "
        f"(~{gb(param_b + 5 * key_b):.1f} GB with the params), a search adds the kernel's "
        f"k-major copy of the db (~{gb(param_b + 2 * key_b):.1f} GB), of "
        f"{gb(torch.cuda.get_device_properties(0).total_memory):.1f} GB")

    # harvest and build, timed apart at from_pairs
    batches = (synthetic_batch(cfg, CORPUS_BATCH, CORPUS_LEN, seed=seed + 1000 + b,
                               device=dev) for b in range(CORPUS_SEQS // CORPUS_BATCH))
    ds, out["harvest_s"], out["build_s"] = harvest_store(fns, params, batches, cfg, dev)
    idx = ds.index
    out.update(keys=ds.engine.n_valid, n_blocks=idx.n_blocks,
               build_launches=tally.counts(),
               build_peak_gb=gb(torch.cuda.max_memory_allocated()))
    log(f"[knn-lm] from_corpus over {CORPUS_SEQS} sequences of {CORPUS_LEN} tokens "
        f"({CORPUS_BATCH} per forward): harvest {out['harvest_s']:.2f} s, build "
        f"{out['build_s']:.2f} s, {out['keys']} keys in {idx.n_blocks} blocks, backend "
        f"{ds.engine.backend_name}, launches {out['build_launches']}; peak "
        f"{out['build_peak_gb']:.2f} GB; {card}")
    check(ds.engine.backend_name == "kernel" and out["keys"] == n_keys
          and bool(idx.valid.all()) and ds.values.shape == (n_keys,),
          "from_corpus built another store than reckoned")
    tally.collect()

    # traffic: each batch of prompts decoded with kNN off, then on
    rec = RecordedStore(ds, tally)
    batches = {b: synthetic_batch(cfg, b, KNNLM_PROMPT, seed=seed + 2000 + b, device=dev)
               for b in KNNLM_REQUESTS}
    runs = decode_runs(fns, params, rec, tally, batches, card, "[knn-lm]")
    rec.close()
    out["runs"] = [r for r, *_ in runs.values()]

    # where a kNN-on step's time goes: one model step and one lookup's
    # search under the profiler, beside their times in the runs
    for b in KNNLM_REQUESTS:
        r, _, _, steps, batch = runs[b, True]
        eng = Engine(fns, params, max_seq=KNNLM_PROMPT + KNNLM_GEN + 8)
        cache, clen, _ = eng.prefill(batch)
        with torch.inference_mode():
            r["model_device"] = device_busy(
                lambda: eng._decode_step(params, batch["tokens"][:, -1:], cache, clen),
                r["model_ms_per_step"], top=6)
        q = steps[0]["q"]
        r["search_device"] = device_busy(lambda: ds.engine.search(q, KNNLM_K),
                                         r["search_ms_per_step"], top=6)
        del cache
        for part in ("model", "search"):
            busy = r[f"{part}_device"]
            log(f"[knn-lm] B = {b}: one {part} step under the profiler kept the card busy "
                f"{busy['busy_ms']:.3f} ms in {busy['kernels']} device events, "
                f"{busy['busy_share']:.3f} of its {r[f'{part}_ms_per_step']:.2f} ms; top: "
                + "; ".join(f"{n[:40]} {ms_:.3f} ms" for n, ms_ in busy["top"]))
    tally.discard()

    # a. every lookup against the brute force over the keys; launches per step
    exact = check_lookups(runs, idx, kernels, "[knn-lm] a.")
    out["exact"] = exact
    tally.discard()

    # b. cache decode against teacher forcing, kNN off
    b = KNNLM_REQUESTS[0]
    _, toks, logits, _, batch = runs[b, False]
    seq = torch.cat([batch["tokens"], batch["tokens"][:, -1:], toks[:, :-1]], dim=1)
    with torch.inference_mode():
        hidden, _, _ = lm.lm_forward(params, seq, cfg)
        want = lm.lm_head_apply(params, hidden[:, KNNLM_PROMPT:], cfg)
    got = torch.stack(logits, dim=1)
    diff = (got - want).abs()
    flips = int((want.argmax(-1) != toks).sum())
    out["teacher_forcing"] = {"max_abs_diff": float(diff.max()),
                              "mean_abs_diff": float(diff.mean()),
                              "logit_std": float(want.std()), "atol": KNNLM_LOGIT_ATOL,
                              "argmax_differs": flips}
    log(f"[knn-lm] b. B = {b}, kNN off: {KNNLM_GEN} cache-decode steps' logits against "
        f"lm_forward over all {seq.shape[1]} positions without cache: max |diff| "
        f"{float(diff.max()):.4f}, mean {float(diff.mean()):.5f} (logit std "
        f"{float(want.std()):.3f}; tolerance {KNNLM_LOGIT_ATOL}); the teacher's argmax "
        f"differs from the greedy token at {flips} of {toks.numel()}")
    check(float(diff.max()) <= KNNLM_LOGIT_ATOL,
          "cache decode departs from teacher forcing past the bf16 tolerance")
    del hidden, want, got, diff

    # c. the bound's soundness at d = 2048
    q64 = runs[KNNLM_REQUESTS[-1], True][3][0]["q"]
    out["soundness"] = bound_soundness(idx, None, q64, "knn-lm d=2048")
    tally.discard()

    # d. CUDA tensors straight into the entry points
    r, toks64, _, steps64, _ = runs[KNNLM_REQUESTS[-1], True]
    last = steps64[-1]["q"]
    keys = lm.embed_hidden(params, last[:KNNLM_ADD], cfg)
    new_toks = toks64[:KNNLM_ADD, -1]
    ids = ds.add_pairs(keys, new_toks)
    _, t_new, i_new = ds.lookup(keys)
    found = (bool((i_new[:, 0].cpu() == torch.tensor(ids, dtype=torch.int32)).all())
             and bool((t_new[:, 0] == new_toks).all()))
    batcher = ds.frontend(max_batch=KNNLM_REQUESTS[-1])

    async def submit_all():
        try:
            return await asyncio.gather(*(batcher.submit(x) for x in last))
        finally:
            await batcher.close()

    answers = asyncio.run(asyncio.wait_for(submit_all(), timeout=600))
    tally.collect()
    s_w, i_w, _ = ds.engine.search(last, KNNLM_K)
    tally.discard()
    s_a = np.stack([a[0] for a in answers])
    i_a = np.stack([a[1] for a in answers])
    batched = (float(np.abs(s_a - s_w.cpu().numpy()).max()) <= 1e-6
               and tie_aware_mismatches(s_a, i_a, s_w.cpu().numpy(),
                                        i_w.cpu().numpy(), 1e-6) == 0)
    hs = torch.cat([st["q"] for st in steps64]).float()
    planted = hs[:KNNLM_DEDUP_PLANTED] + 1e-3 * torch.randn(
        KNNLM_DEDUP_PLANTED, hs.shape[1], device=dev,
        generator=torch.Generator(dev).manual_seed(seed))
    emb = torch.cat([hs, planted])
    pairs, dstats = find_near_duplicates(emb, threshold=0.95, k=8, device=dev)
    want_pairs, edge = brute_pairs(emb, 0.95, 8)
    n = hs.shape[0]
    planted_found = len({(i, n + i) for i in range(KNNLM_DEDUP_PLANTED)} & set(pairs))
    dedup_ok = (not (set(pairs) ^ want_pairs) - edge
                and planted_found == KNNLM_DEDUP_PLANTED)
    tally.collect()
    out["cuda_entry_points"] = {
        "add_pairs_found": found, "batcher_equals_search": batched,
        "batcher_batches": batcher.n_batches, "dedup_docs": int(emb.shape[0]),
        "dedup_pairs": len(pairs), "dedup_brute_pairs": len(want_pairs),
        "dedup_planted_found": planted_found, "dedup_ok": dedup_ok,
        "dedup_backend": dstats.backend}
    log(f"[knn-lm] d. CUDA tensors into the entry points: from_corpus took the model's "
        f"hidden states (above); add_pairs of {KNNLM_ADD} hidden states and their tokens, "
        f"each found at top-1 by its lookup: {found}; ContinuousBatcher.submit of "
        f"{last.shape[0]} hidden states ({batcher.n_batches} batches) equal to the "
        f"search: {batched}; find_near_duplicates on {emb.shape[0]} hidden states "
        f"({KNNLM_DEDUP_PLANTED} near-copies planted, backend {dstats.backend}): "
        f"{len(pairs)} pairs, the brute force {len(want_pairs)}, planted found "
        f"{planted_found}: {dedup_ok}")
    check(found and batched and dedup_ok, "an entry point misbehaved on CUDA tensors")

    out["launches"] = dict(tally.total)
    out["peak_gb"] = gb(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    for name in path:
        check(out["launches"][name] > 0, f"phase 12's path never launched {name}")
    off8, on8 = runs[KNNLM_REQUESTS[0], False][0], runs[KNNLM_REQUESTS[0], True][0]
    off64, on64 = runs[KNNLM_REQUESTS[-1], False][0], runs[KNNLM_REQUESTS[-1], True][0]
    log(f"[knn-lm] phase 12 on {card}: harvest {out['harvest_s']:.2f} s, build "
        f"{out['build_s']:.2f} s; prefill {off8['prefill_tok_s']:.0f} / "
        f"{off64['prefill_tok_s']:.0f} tok/s; decode kNN off {off8['decode_tok_s']:.1f} / "
        f"{off64['decode_tok_s']:.1f} tok/s, on {on8['decode_tok_s']:.1f} / "
        f"{on64['decode_tok_s']:.1f} tok/s (B = {KNNLM_REQUESTS[0]} / "
        f"{KNNLM_REQUESTS[-1]}); search {on8['search_ms_per_step']:.2f} / "
        f"{on64['search_ms_per_step']:.2f} ms a step ({on8['search_share']:.3f} / "
        f"{on64['search_share']:.3f} of it), model {on8['model_ms_per_step']:.2f} / "
        f"{on64['model_ms_per_step']:.2f} ms; peak {out['peak_gb']:.2f} GB; launches "
        f"{out['launches']}; {out['seconds']:.1f} s")
    del ds, rec, runs, params
    torch.cuda.empty_cache()
    return out


def moe_hooks(params, cfg, pre):
    """Registers ``pre(i, module, args, kwargs)`` as a forward pre-hook on
    the MoE of each "moe" layer i of ``cfg.layer_types`` (args: the layer's
    input [B, S, D] and the config; kwargs: no_drop, experts); returns the
    function that removes them."""
    moes = [params.blocks[li].moe for li, t in enumerate(cfg.layer_types) if t == "moe"]
    handles = [m.register_forward_pre_hook(
        lambda mod, args, kwargs, i=i: pre(i, mod, args, kwargs), with_kwargs=True)
        for i, m in enumerate(moes)]
    return lambda: [h.remove() for h in handles]


def moe_drops(params, cfg, fn):
    """Run ``fn()`` counting the (token, expert) assignments that the MoE
    layers dropped past their capacity."""
    from repro_torch.models import moe as moe_mod

    drops = collections.Counter()

    def count(i, mod, args, kwargs):
        x, c = args[0].reshape(-1, args[0].shape[-1]), args[1]
        cap = x.shape[0] if kwargs.get("no_drop") else moe_mod._capacity(x.shape[0], c.moe)
        _, _, gate_e = moe_mod._route(mod, x, c)
        _, keep, _, token_of = moe_mod._dispatch(gate_e, c.moe.n_experts, cap)
        drops["assignments"] += keep.numel()
        drops["dropped"] += int((~keep).sum())
        drops["tokens_with_a_drop"] += int(torch.unique(token_of[~keep]).numel())

    undo = moe_hooks(params, cfg, count)
    try:
        fn()
    finally:
        undo()
    return dict(drops)


def moe_replay(params, cfg, prompt, toks, experts=None):
    """Check b's two paths for an MoE with the expert choices held equal.

    The teacher is one cache-path prefill (no_drop) of the whole
    teacher-forced sequence; it routes afresh, or takes ``experts`` (one
    [B, P + G, K] per MoE layer).  The path under test is a prefill of the
    prompt and one decode step per generated token; at every (layer,
    position) it takes the teacher's experts, weighted by its own router's
    probabilities, so only the two paths' arithmetic differs.  GEMMs of
    other shapes would otherwise move a near-tie of the router and send a
    position to another expert.  Returns the teacher's logits [B, G, V],
    the path's, the experts, and the (layer, row, position) triples where
    the path's own router would have chosen another set."""
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod

    B, P = prompt.shape
    G = toks.shape[1]
    seq = torch.cat([prompt, prompt[:, -1:], toks[:, :-1]], dim=1)
    experts = [] if experts is None else [e.to(seq.device) for e in experts]
    at = {"pos": 0, "flips": 0, "of": 0}

    def teacher(i, mod, args, kwargs):
        x, c = args[0], args[1]
        if len(experts) <= i:
            experts.append(moe_mod._route(mod, x.reshape(-1, x.shape[-1]), c)[2]
                           .view(B, x.shape[1], -1))
        kwargs["experts"] = experts[i]
        return args, kwargs

    def path(i, mod, args, kwargs):
        x, c = args[0], args[1]
        want = experts[i][:, at["pos"]:at["pos"] + x.shape[1]]
        own = moe_mod._route(mod, x.reshape(-1, x.shape[-1]), c)[2].view(want.shape)
        at["flips"] += (own.sort(-1).values != want.sort(-1).values).any(-1).sum()
        at["of"] += want.shape[0] * want.shape[1]
        kwargs["experts"] = want
        return args, kwargs

    with torch.inference_mode():
        undo = moe_hooks(params, cfg, teacher)
        try:
            cache = lm.lm_cache_init(cfg, B, P + G, device=seq.device)
            h, _, _ = lm.lm_forward(params, seq, cfg, cache=cache, cache_len=0)
            want = lm.lm_head_apply(params, h[:, P:], cfg)
        finally:
            undo()
        undo = moe_hooks(params, cfg, path)
        try:
            cache = lm.lm_cache_init(cfg, B, P + G, device=seq.device)
            _, cache, _ = lm.lm_forward(params, seq[:, :P], cfg, cache=cache, cache_len=0)
            got = []
            for i in range(G):
                at["pos"] = P + i
                h, cache, _ = lm.lm_forward(params, seq[:, P + i:P + i + 1], cfg, cache=cache,
                                            cache_len=P + i)
                got.append(lm.lm_head_apply(params, h, cfg)[:, -1])
        finally:
            undo()
    return {"want": want, "got": torch.stack(got, dim=1), "experts": experts,
            "flips": int(at["flips"]), "of_pairs": at["of"]}


def logit_gap(got, want):
    """max and mean |got - want| beside want's std."""
    diff = (got.float() - want.float()).abs()
    std = float(want.float().std())
    return {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
            "logit_std": std, "rel": float(diff.max()) / std}


def moe_check_b(params, cfg, prompt, toks, tag):
    """Check b for an MoE (see phase_families): the teacher's experts
    replayed into the cache path (moe_replay), in bf16 within
    FAMILY_MOE_BF16_REL_ATOL and in float32 activations within
    FAMILY_MOE_FP32_REL_ATOL of the teacher's logit std; the tokens that
    the cache-free forward (capacity dispatch) drops, printed."""
    from repro_torch.models import lm

    seq = torch.cat([prompt, prompt[:, -1:], toks[:, :-1]], dim=1)
    with torch.inference_mode():
        drops = moe_drops(params, cfg, lambda: lm.lm_forward(params, seq, cfg))
    bf = moe_replay(params, cfg, prompt, toks)
    f32 = moe_replay(params, cfg.replace(dtype="float32"), prompt, toks,
                     experts=bf["experts"])
    out = {"teacher": "one cache-path prefill (no_drop) of the whole sequence, its experts "
                      "replayed into the cache path",
           **logit_gap(bf["got"], bf["want"]), "rel_atol": FAMILY_MOE_BF16_REL_ATOL,
           "argmax_differs": int((bf["want"].argmax(-1) != toks).sum()),
           "routing_differs": bf["flips"], "of_pairs": bf["of_pairs"],
           "float32": {**logit_gap(f32["got"], f32["want"]),
                       "rel_atol": FAMILY_MOE_FP32_REL_ATOL},
           "cache_free_forward_drops": drops}
    log(f"{tag} b. the cache-free forward (capacity dispatch) dropped {drops['dropped']} of "
        f"{drops['assignments']} (token, expert) assignments ({drops['tokens_with_a_drop']} "
        f"token-layer pairs with a drop); the cache path drops none.  Its own router would "
        f"route {bf['flips']} of {bf['of_pairs']} (layer, row, position) triples of the "
        f"cache path otherwise; the teacher's experts are replayed into it")
    for name, m in (("bfloat16", out), ("float32", out["float32"])):
        log(f"{tag} b. {name} activations, B = {prompt.shape[0]}: {toks.shape[1]} cache-decode "
            f"steps' logits against {out['teacher']}: max |diff| {m['max_abs_diff']:.4e}, mean "
            f"{m['mean_abs_diff']:.4e}, logit std {m['logit_std']:.3f}, max over std "
            f"{m['rel']:.4e} (tolerance {m['rel_atol']})")
    check(out["rel"] <= FAMILY_MOE_BF16_REL_ATOL,
          f"{tag} cache decode departs from teacher forcing (bfloat16, the same experts)")
    check(out["float32"]["rel"] <= FAMILY_MOE_FP32_REL_ATOL,
          f"{tag} cache decode departs from teacher forcing (float32, the same experts)")
    return out


def rel_diff(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def recurrent_check(fns, params, batch, cfg):
    """Check c on one request's prompt, in float32 at full width: rwkv6's
    _wkv_chunked against _wkv_scan on the first layer's r, k, v, w (taken
    as rwkv6_apply passes them on); Mamba2's chunked mamba2_apply (from a
    zero state) against its recurrent update one token at a time, on the
    first layer's input.  Outputs and final states, max |diff| over max
    |value|."""
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import norm_apply

    c32 = cfg.replace(dtype="float32")
    with torch.inference_mode():
        x = params.embed["table"][batch["tokens"][:1].long()].float()
        block = params.blocks[0]
        if block.btype == "rwkv6":
            seen = {}
            real = rwkv_mod._wkv_chunked

            def keep_inputs(*a, **kw):
                seen["args"] = a
                return real(*a, **kw)

            rwkv_mod._wkv_chunked = keep_inputs
            try:
                rwkv_mod.rwkv6_apply(block.rwkv, x, c32, chunked=True,
                                     cache=rwkv_mod.rwkv6_cache_init(c32, 1, device=x.device))
            finally:
                rwkv_mod._wkv_chunked = real
            (o_c, s_c), (o_s, s_s) = real(*seen["args"]), rwkv_mod._wkv_scan(*seen["args"])
            what = "rwkv6 layer 0: _wkv_chunked against _wkv_scan"
        else:
            h = norm_apply(block.ln1, x, c32)
            o_c, st_c = ssm_mod.mamba2_apply(block.ssm, h, c32,
                                             cache=ssm_mod.mamba2_cache_init(c32, 1,
                                                                             device=x.device))
            st = ssm_mod.mamba2_cache_init(c32, 1, device=x.device)
            outs = []
            for t in range(h.shape[1]):
                o, st = ssm_mod.mamba2_apply(block.ssm, h[:, t:t + 1], c32, cache=st)
                outs.append(o)
            o_s = torch.cat(outs, 1)
            s_c, s_s = st_c["ssm_state"], st["ssm_state"]
            what = "mamba2 layer 0: chunked mamba2_apply against the recurrent update"
    out = {"what": what, "tokens": int(x.shape[1]), "out_rel": rel_diff(o_c, o_s),
           "state_rel": rel_diff(s_c, s_s), "rtol": FAMILY_RECURRENT_RTOL}
    return out


def family_model(arch, seed, card, kernels):
    """Phase 13 for one arch: the launcher at its defaults, then the model
    at full width and depth, its store, the traffic and checks a-d (see
    phase_families).  Returns its report and its launches."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm, model_fns, synthetic_batch
    from repro_torch.models.vlm import vlm_forward
    from repro_torch.models.whisper import whisper_forward

    t_model = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = gb(torch.cuda.memory_allocated())       # what earlier phases still hold
    dev = torch.device("cuda")
    cfg = ARCHS[arch]
    fns = model_fns(cfg)
    tag = f"[families] {arch}:"
    tally = LaunchTally(kernels)
    path = tuple(kern.__name__ for kern in kernels[:2])
    out = {"arch": arch, "kind": fns.kind, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "layer_types": sorted(set(cfg.layer_types)), "card": card,
           "resident_gb_at_start": resident}

    # the launcher: full width, its own defaults
    out["launcher"] = run_launcher(["--arch", arch, "--knn"], cfg, tally, tag)

    # the model, its store (harvest and build timed apart at from_pairs)
    params = fns.init(seed, device=dev)
    out["params_gb"] = gb(sum(p.numel() * p.element_size() for p in params.parameters()))
    seq_len = min(FAMILY_LEN, cfg.max_seq_len)
    n_keys = FAMILY_SEQS * (seq_len - 1)
    batches = (synthetic_batch(cfg, FAMILY_BATCH, seq_len, seed=seed + 1000 + b, device=dev)
               for b in range(FAMILY_SEQS // FAMILY_BATCH))
    ds, out["harvest_s"], out["build_s"] = harvest_store(fns, params, batches, cfg, dev)
    idx = ds.index
    out.update(keys=ds.engine.n_valid, n_blocks=idx.n_blocks, seq_len=seq_len,
               build_launches=tally.counts())
    log(f"{tag} {cfg.n_layers} layers {out['layer_types']}, d_model {cfg.d_model}, "
        f"{cfg.dtype} activations, {out['params_gb']:.2f} GB of {cfg.param_dtype} params; "
        f"from_corpus over {FAMILY_SEQS} sequences of {seq_len} tokens"
        + (f" (+{cfg.vision_seq} vision positions each)" if cfg.vision_seq else "")
        + f": harvest {out['harvest_s']:.2f} s, build {out['build_s']:.2f} s, "
        f"{out['keys']} keys in {idx.n_blocks} blocks, backend {ds.engine.backend_name}; "
        f"{card}")
    check(ds.engine.backend_name == "kernel" and out["keys"] == n_keys
          and bool(idx.valid.all()), f"{tag} from_corpus built another store than reckoned")
    tally.collect()

    # traffic: B = 8 and 64, kNN off and on; B = 8 kNN off decoded twice (d)
    rec = RecordedStore(ds, tally)
    batches = {b: synthetic_batch(cfg, b, KNNLM_PROMPT, seed=seed + 2000 + b, device=dev)
               for b in KNNLM_REQUESTS}
    b8 = KNNLM_REQUESTS[0]
    runs = decode_runs(fns, params, rec, tally, batches, card, tag, again=((b8, False),))
    rec.close()
    out["runs"] = [r for r, *_ in runs.values()]
    out["launches"] = dict(tally.total)      # the launcher's, the build's, the runs'
    tally.discard()

    # a. every kNN-on step's lookup against the brute force; launches per step
    out["exact"] = check_lookups(runs, idx, kernels, f"{tag} a.")
    tally.discard()

    # b. cache decode against teacher forcing, B = 8, kNN off
    r8, toks, logits, _, batch = runs[b8, False]
    if "moe" in cfg.layer_types:
        out["teacher_forcing"] = moe_check_b(params, cfg, batch["tokens"], toks, tag)
    else:
        seq = torch.cat([batch["tokens"], batch["tokens"][:, -1:], toks[:, :-1]], dim=1)
        with torch.inference_mode():
            if fns.kind == "vlm":
                hidden, _, _ = vlm_forward(params, batch["patches"], seq, cfg)
                hidden = hidden[:, cfg.vision_seq:]
                teacher = "vlm_forward with the patches"
            elif fns.kind == "whisper":
                hidden, _, _ = whisper_forward(params, batch["frames"], seq, cfg)
                teacher = "whisper_forward with the frames"
            else:
                hidden, _, _ = lm.lm_forward(params, seq, cfg)
                teacher = "lm_forward without cache (chunked)"
            want = fns.lm_head(params, hidden[:, KNNLM_PROMPT:])
        got = torch.stack(logits, dim=1)
        tf = out["teacher_forcing"] = {
            "teacher": teacher, **logit_gap(got, want), "rel_atol": FAMILY_LOGIT_REL_ATOL,
            "argmax_differs": int((want.argmax(-1) != toks).sum())}
        log(f"{tag} b. B = {b8}, kNN off: {KNNLM_GEN} cache-decode steps' logits against "
            f"{teacher}: max |diff| {tf['max_abs_diff']:.4f}, mean {tf['mean_abs_diff']:.5f}, "
            f"logit std {tf['logit_std']:.3f}, max over std {tf['rel']:.4f} (tolerance "
            f"{FAMILY_LOGIT_REL_ATOL}); the teacher's argmax differs from the greedy token at "
            f"{tf['argmax_differs']} of {toks.numel()}")
        check(tf["rel"] <= FAMILY_LOGIT_REL_ATOL,
              f"{tag} cache decode departs from teacher forcing past the bf16 tolerance")
        del hidden, want, got

    # c. the recurrent paths in float32 at full width
    if cfg.layer_types[0] in ("rwkv6", "mamba2"):
        rc = out["recurrent"] = recurrent_check(fns, params, batch, cfg)
        log(f"{tag} c. {rc['what']} over {rc['tokens']} tokens in float32: max relative "
            f"diff of the outputs {rc['out_rel']:.3e}, of the final states "
            f"{rc['state_rel']:.3e} (tolerance {FAMILY_RECURRENT_RTOL})")
        check(rc["out_rel"] <= FAMILY_RECURRENT_RTOL and rc["state_rel"] <= FAMILY_RECURRENT_RTOL,
              f"{tag} the chunked and the recurrent form disagree")

    # d. two decodes from one prefilled cache
    out["deterministic"] = r8["again_equal"]
    log(f"{tag} d. two greedy decodes of {KNNLM_GEN} tokens from one prefilled cache "
        f"(B = {b8}, kNN off) give the same tokens: {r8['again_equal']}")
    check(r8["again_equal"], f"{tag} two decodes from one cache differ")

    out["peak_gb"] = gb(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_model
    for name in path:
        check(out["launches"][name] > 0, f"{tag} the path never launched {name}")
    off8, on8 = runs[b8, False][0], runs[b8, True][0]
    off64, on64 = runs[KNNLM_REQUESTS[-1], False][0], runs[KNNLM_REQUESTS[-1], True][0]
    log(f"{tag} on {card}: params {out['params_gb']:.2f} GB, peak {out['peak_gb']:.2f} GB "
        f"({resident:.2f} GB of it held by earlier phases); "
        f"harvest {out['harvest_s']:.2f} s, build {out['build_s']:.2f} s; prefill "
        f"{off8['prefill_tok_s']:.0f} / {off64['prefill_tok_s']:.0f} tok/s; decode kNN off "
        f"{off8['decode_tok_s']:.1f} / {off64['decode_tok_s']:.1f} tok/s, on "
        f"{on8['decode_tok_s']:.1f} / {on64['decode_tok_s']:.1f} tok/s (B = {b8} / "
        f"{KNNLM_REQUESTS[-1]}); search {on8['search_ms_per_step']:.2f} / "
        f"{on64['search_ms_per_step']:.2f} ms a step ({on8['search_share']:.3f} / "
        f"{on64['search_share']:.3f} of it); launches {out['launches']}; "
        f"{out['seconds']:.1f} s")
    del ds, rec, runs, params, batches, batch
    torch.cuda.empty_cache()
    return out


def phase_families(seed, card, kernels, archs=FAMILY_ARCHS):
    """Phase 13: kNN-LM serving across the model families at full width.

    For each arch of ``archs`` in turn (one model on the card at a time):
    ``repro_torch.launch.serve.main(["--arch", arch, "--knn"])`` at its
    defaults; then ARCHS[arch] at full width and depth with random weights
    from ``seed``, its store from ``from_corpus`` (FAMILY_SEQS x FAMILY_LEN
    tokens), and 8 and 64 prompts of KNNLM_PROMPT tokens (with the kind's
    patches or frames) decoded KNNLM_GEN greedy tokens through Engine with
    kNN off and on.  ``kernels`` as in phase_knnlm.  Checks, each fatal:

    a. every kNN-on step's lookup against brute_topk over the keys
       (tie-aware), one launch of each of kernels[:2] per step, none of the
       rest (check_lookups);
    b. B = 8, kNN off: every decode step's logits against the cache-free
       forward over the whole sequence (lm_forward, vlm_forward with the
       patches, whisper_forward with the frames), within
       FAMILY_LOGIT_REL_ATOL of the teacher's logit std.  For zamba2 and
       rwkv6 this is also the chunked path (prefill) against the recurrent
       one (decode).  An MoE's cache-free forward drops tokens past
       capacity and its cache path does not, so its teacher is one
       cache-path prefill of the whole sequence (the drops printed); its
       routing flips between GEMMs of other shapes, so the teacher's
       expert choices are replayed into the cache path, in bf16 and in
       float32 activations (moe_check_b, FAMILY_MOE_BF16_REL_ATOL,
       FAMILY_MOE_FP32_REL_ATOL);
    c. rwkv6 and zamba2: the chunked and the recurrent form of the first
       layer in float32 at full width (recurrent_check);
    d. two greedy decodes from one prefilled cache give the same tokens.

    The path's launches are counted over the launcher, the harvest and
    build and the decode runs; the checks' own launches are not."""
    t_phase = time.perf_counter()
    out = {"models": {}}
    total = collections.Counter({kern.__name__: 0 for kern in kernels})
    for i, arch in enumerate(archs):
        r = family_model(arch, seed + i, card, kernels)
        out["models"][arch] = r
        total.update(r["launches"])
    out["launches"] = dict(total)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[families] phase 13 on {card}: {len(archs)} models, launches {out['launches']}, "
        f"{out['seconds']:.1f} s")
    return out


#: phase 14, training at full width: the reference's whole-system flow
#: (tests/test_system.py: embed -> dedup -> train -> datastore -> kNN-LM
#: serving) on TRAIN_ARCH at full width, cut to TRAIN_LAYERS of its 22
#: layers (phase 16 trains it at full depth, on the host path and on a
#: mesh, and times both), remat on.  The run draws
#: TRAIN_STEPS batches of TRAIN_BATCH x TRAIN_SEQ SyntheticLM tokens (8,192 a
#: step), with duplicate passages planted into them: the dedup's documents
#: are the passages of DEDUP_DOC tokens of those batches (1,920), of which
#: DEDUP_PLANTED are copies of others (half exact, half with DEDUP_EDITS
#: tokens changed).  SyntheticLM's text repeats its Markov chains, so most
#: passages have natural near-duplicates too (up to 109 at the threshold,
#: seed 14): DEDUP_K lies above that, so the k-nearest cut drops no pair
#: and the answer is every pair at the threshold.  The learning rate is
#: launch/train.py's warmup_cosine
TRAIN_ARCH, TRAIN_LAYERS = "tinyllama-1.1b", 11
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 30, 3e-4
DEDUP_DOC, DEDUP_PLANTED, DEDUP_EDITS, DEDUP_THRESHOLD, DEDUP_K = 128, 32, 2, 0.95, 120
#: the trained model's store: from_corpus over TRAIN_STORE_SEQS x TRAIN_SEQ
#: tokens; TRAIN_DECODE greedy kNN-on steps at B = TRAIN_BATCH
TRAIN_STORE_SEQS, TRAIN_DECODE = 128, 64
#: check b: a checkpoint at RESTART_AT, a fresh Trainer resumes to RESTART_TO
RESTART_AT, RESTART_TO, RESTART_LOSS_ATOL = 10, 20, 1e-4
#: check c: a GRAD_LAYERS-layer copy of TRAIN_ARCH at full width in float32,
#: one loss and backward on the card, and in float64 on the host's CPU (the
#: truth: a float32 CPU run's own rounding moves with the host's BLAS path)
#: at GRAD_BATCH x GRAD_SEQ tokens: the loss within GRAD_LOSS_RTOL, each
#: gradient within GRAD_RTOL of its leaf's max |gradient|
GRAD_LAYERS, GRAD_BATCH, GRAD_SEQ, GRAD_LOSS_RTOL, GRAD_RTOL = 2, 2, 256, 1e-5, 1e-4
#: check d: |err| <= scale * ERR_HALF_STEP: the quantizer's half step, and
#: the float32 roundings of t / s, q * s and t - q * s (t / s < 128 is
#: within 2^-18 of its value, q * s within 2^-17 s of its, each below
#: 2^-16 s)
ERR_HALF_STEP = 0.5 + 2 ** -15
#: check e: one train step of each FAMILY_ARCHS model at full width and
#: depth, FAMILY_TRAIN_BATCH x FAMILY_LEN tokens (or cfg.max_seq_len), a
#: constant learning rate of TRAIN_LR (warmup_cosine's first step is 0)
FAMILY_TRAIN_BATCH = 2


class PlantedCorpus:
    """The batches the run draws: ``steps`` SyntheticLM batches with
    ``DEDUP_PLANTED`` passages of DEDUP_DOC tokens overwritten by copies of
    others (the second half with DEDUP_EDITS tokens changed); labels are
    the next tokens, as SyntheticLM's.  ``pairs`` are the planted (source,
    copy) document indices, documents being the passages in batch order."""

    def __init__(self, vocab, seq, batch, steps, seed):
        from repro_torch.data.pipeline import SyntheticLM

        self.src = SyntheticLM(vocab, seq, batch, seed=seed)
        toks = np.concatenate([self.src.batch(s)["tokens"] for s in range(steps)])
        docs = toks.reshape(-1, DEDUP_DOC)                    # a view: writes go to toks
        rng = np.random.default_rng(seed)
        picked = rng.choice(len(docs), 2 * DEDUP_PLANTED, replace=False)
        self.pairs = []
        for i, (a, b) in enumerate(zip(picked[::2], picked[1::2])):
            docs[b] = docs[a]
            if i >= DEDUP_PLANTED // 2:
                at = rng.choice(DEDUP_DOC, DEDUP_EDITS, replace=False)
                docs[b, at] = (docs[b, at] + 1 + rng.integers(0, vocab - 1, DEDUP_EDITS)) % vocab
            self.pairs.append((int(min(a, b)), int(max(a, b))))
        self.tokens, self.batch_size, self.docs = toks, batch, docs

    def batch(self, step):
        tok = self.tokens[step * self.batch_size:(step + 1) * self.batch_size].copy()
        labels = np.roll(tok, -1, axis=1)
        labels[:, -1] = tok[:, 0]
        return {"tokens": tok, "labels": labels}

    def state(self):
        return {"kind": "planted", "seed": self.src.seed}

    def restore(self, state):
        assert state.get("kind") == "planted"


class TimedCheckpoints:
    """Times a Trainer's CheckpointManager: each save call (for an async
    save, the host copy; for a blocking one, the whole write), each wait
    for an async write, each restore; and the bytes of each step
    directory written."""

    def __init__(self, cm):
        self.cm, self.events = cm, []
        save, wait, restore = cm.save, cm.wait, cm.restore

        def timed_save(step, tree, *, extra=None, block=False):
            t0 = time.perf_counter()
            save(step, tree, extra=extra, block=block)
            self.events.append({"save": step, "block": block or not cm.async_save,
                                "s": time.perf_counter() - t0})

        def timed_wait():
            busy = cm._thread is not None
            t0 = time.perf_counter()
            wait()
            if busy:
                self.events.append({"wait": True, "s": time.perf_counter() - t0})

        def timed_restore(*a, **kw):
            t0 = time.perf_counter()
            out = restore(*a, **kw)
            self.events.append({"restore": out[2], "s": time.perf_counter() - t0})
            return out

        cm.save, cm.wait, cm.restore = timed_save, timed_wait, timed_restore

    def step_bytes(self, step):
        d = Path(self.cm.dir) / f"step_{step:08d}"
        return sum(f.stat().st_size for f in d.iterdir())


def train_run(fns, cfg, data, ckpt_dir, total, seed, dev, *, ckpt_every=10 ** 9, keep=1):
    """A Trainer over a fresh state from ``seed`` with launch/train.py's
    schedule for TRAIN_STEPS steps; returns (trainer, its output, its
    TimedCheckpoints)."""
    import functools

    from repro_torch.optim import schedule
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    step_fn = make_train_step(fns, cfg, lr_schedule=functools.partial(
        schedule.warmup_cosine, peak_lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 5),
        total_steps=TRAIN_STEPS))
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                       keep=keep, log_every=10)
    tr = Trainer(step_fn, init_state(fns, seed, device=dev), data, tc)
    timed = TimedCheckpoints(tr.ckpt)
    out = tr.run(install_signal=False)
    torch.cuda.synchronize()
    return tr, out, timed


def step_stats(history):
    """ms per step (median and mean past the first step) and tokens/s."""
    ms = np.array([h["time_s"] for h in history[1:]]) * 1e3
    return {"ms_median": float(np.median(ms)), "ms_mean": float(ms.mean()),
            "first_ms": history[0]["time_s"] * 1e3}


def grads_of(fns, cfg, params, batch):
    """{name: gradient} of the train step's loss at ``params`` (and the
    loss); the parameters' .grad are cleared after."""
    from repro_torch.train.train_step import make_loss_fn

    loss, _ = make_loss_fn(fns, cfg)(params, batch)
    loss.backward()
    out = {n: p.grad for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return loss.detach(), out


def grads_of_float64(cfg, params, batch):
    """:func:`grads_of` of a float64 copy of ``params`` on the CPU: the
    model and its activations in float64, and ``Tensor.float`` (with which
    the layers compute their norms, softmaxes and losses) made ``double``
    for the call."""
    import copy

    from repro_torch.models import model_fns

    c64 = cfg.replace(dtype="float64", param_dtype="float64")
    m64 = copy.deepcopy(params).to("cpu").double()
    as_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        return grads_of(model_fns(c64), c64, m64, batch)
    finally:
        torch.Tensor.float = as_float


def phase_train(seed, card, kernels):
    """Phase 14: training at full width.

    a. Dedup -> train -> serve, on ARCHS[TRAIN_ARCH] at full width, cut
       to TRAIN_LAYERS layers: find_near_duplicates over the passages of the run's planted
       batches (every planted pair found, the pairs equal to brute_pairs,
       one launch of each of kernels[:2]); TRAIN_STEPS steps through
       Trainer (every loss finite, grad_norm finite and > 0, the mean of
       the last 5 losses below the first 5's); from_corpus with the
       trained weights over TRAIN_STORE_SEQS x TRAIN_SEQ tokens and
       TRAIN_DECODE greedy steps at B = TRAIN_BATCH, kNN off and on, every
       lookup exact with one launch of each kernel a step (check_lookups).
    b. Restart: an async checkpoint at RESTART_AT from a fresh Trainer of
       the same seed, then another fresh Trainer on its directory resumes
       to RESTART_TO; its losses equal a's within RESTART_LOSS_ATOL.
    c. One loss and backward of a GRAD_LAYERS-layer float32 copy on the
       card, against the same in float64 on the CPU from the same weights
       and batch (a float32 CPU run's distances are logged too).
    d. One full-width step with compress_grads: |err| within the
       quantizer's half step of its leaf's scale, the loss finite.
    e. One train step of each FAMILY_ARCHS model at full width and depth,
       then a second on the same batch, which must lower the loss; every
       parameter a finite gradient, the MoE router's nonzero.

    The path's launches are the dedup's, the store's build and the decode
    runs'; the checks' own are not counted.  The checkpoints (13.2 GB each
    at full width) go under build/train_ckpt, which is removed as soon as
    a run's are read and, whatever happens, when the phase ends.  b's
    resumed Trainer ends with the Trainer's blocking final save (the
    reference's): its time is a second reading of a blocking save."""
    import shutil

    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        return train_checks(seed, card, kernels, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def train_checks(seed, card, kernels, ckpt_root):
    """The checks of :func:`phase_train`, its checkpoints under
    ``ckpt_root``."""
    import copy
    import functools
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.data.dedup import dedup_mask, embed_tokens, find_near_duplicates
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model_fns, synthetic_batch
    from repro_torch.models.registry import reference_paths
    from repro_torch.optim import schedule
    from repro_torch.train.train_step import init_state, make_train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = ARCHS[TRAIN_ARCH].replace(n_layers=TRAIN_LAYERS)
    fns = model_fns(cfg)
    tally = LaunchTally(kernels)
    path = tuple(kern.__name__ for kern in kernels[:2])
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "remat": cfg.remat, "batch": [TRAIN_BATCH, TRAIN_SEQ], "card": card}
    tag = "[train]"

    # a. the planted corpus, its dedup on the card
    t0 = time.perf_counter()
    data = PlantedCorpus(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, seed)
    emb = embed_tokens(data.docs)
    t1 = time.perf_counter()
    tally.discard()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pairs, dstats = find_near_duplicates(emb, threshold=DEDUP_THRESHOLD, k=DEDUP_K, device=dev)
    torch.cuda.synchronize()
    dedup_s = time.perf_counter() - t2
    dedup_launches = tally.counts()
    tally.collect()
    e = torch.nn.functional.normalize(torch.as_tensor(emb, device=dev), dim=1)
    most = int(((e @ e.T) >= DEDUP_THRESHOLD).sum(1).max()) - 1
    want_pairs, edge = brute_pairs(e, DEDUP_THRESHOLD, DEDUP_K)
    found = len(set(data.pairs) & set(pairs))
    keep = dedup_mask(len(emb), pairs)
    out["dedup"] = {"docs": int(len(emb)), "doc_tokens": DEDUP_DOC, "planted": len(data.pairs),
                    "planted_found": found, "pairs": len(pairs), "brute_pairs": len(want_pairs),
                    "kept": int(keep.sum()), "backend": dstats.backend, "s": dedup_s,
                    "k": DEDUP_K, "most_neighbours": most,
                    "corpus_s": t1 - t0, "launches": dedup_launches}
    log(f"{tag} a. dedup of the run's {len(emb)} passages of {DEDUP_DOC} tokens "
        f"({len(data.pairs)} planted copies, {DEDUP_PLANTED // 2} with {DEDUP_EDITS} tokens "
        f"changed): find_near_duplicates on the card {dedup_s:.3f} s (backend "
        f"{dstats.backend}, launches {dedup_launches}), {len(pairs)} pairs, the brute force "
        f"{len(want_pairs)}, planted found {found}, {int(keep.sum())} passages kept (k = "
        f"{DEDUP_K}; at most {most} neighbours of a passage at the threshold); the corpus "
        f"and its embedding {t1 - t0:.2f} s on the host")
    check(most < DEDUP_K, f"{tag} a passage has more neighbours at the threshold than k")
    check(found == len(data.pairs), f"{tag} the dedup missed a planted pair")
    check(not (set(pairs) ^ want_pairs) - edge,
          f"{tag} the dedup's pairs differ from the brute force")
    check(dedup_launches == {kern.__name__: int(kern.__name__ in path) for kern in kernels},
          f"{tag} the dedup did not launch each of {path} once")

    # a. 30 steps through Trainer, uninterrupted
    torch.cuda.reset_peak_memory_stats()
    tr, run_a, timed_a = train_run(fns, cfg, data, ckpt_root / "a", TRAIN_STEPS, seed, dev)
    hist = run_a["history"]
    losses = [h["loss"] for h in hist]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    st = step_stats(hist)
    params = tr.state["params"]
    n_params = sum(p.numel() for p in params.parameters())
    out["train"] = {
        **st, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (st["ms_median"] / 1e3),
        "peak_gb": gb(torch.cuda.max_memory_allocated()), "params": n_params,
        "state_gb": gb(4 * 3 * n_params), "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist], "lrs": [h["lr"] for h in hist],
        "first5": first, "last5": last, "final_save": timed_a.events,
        "final_ckpt_gb": gb(timed_a.step_bytes(TRAIN_STEPS))}
    shutil.rmtree(ckpt_root / "a")
    tw = out["train"]
    log(f"{tag} a. {TRAIN_STEPS} steps of {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, remat {cfg.remat}) at B = {TRAIN_BATCH}, S = "
        f"{TRAIN_SEQ}: {tw['ms_median']:.1f} ms a step (median; mean {tw['ms_mean']:.1f}, "
        f"first {tw['first_ms']:.0f}), {tw['tokens_per_s']:.0f} tokens/s, peak "
        f"{tw['peak_gb']:.2f} GB (fp32 params + m + v {tw['state_gb']:.2f} GB); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 {first:.4f}, last 5 {last:.4f}); "
        f"the final blocking checkpoint {tw['final_ckpt_gb']:.2f} GB in "
        f"{timed_a.events[-1]['s']:.1f} s; {card}")
    check(all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0 for h in hist),
          f"{tag} a loss or grad_norm is not finite")
    check(last < first, f"{tag} the loss did not decrease over {TRAIN_STEPS} steps")

    # a. the trained model's store and kNN-LM decoding
    tr.state.pop("opt")
    tr.ckpt.wait()
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tally.discard()
    batches = (synthetic_batch(cfg, 16, TRAIN_SEQ, seed=seed + 1000 + b, device=dev)
               for b in range(TRAIN_STORE_SEQS // 16))
    ds, harvest_s, build_s = harvest_store(fns, params, batches, cfg, dev)
    build_launches = tally.counts()
    tally.collect()
    rec = RecordedStore(ds, tally)
    prompts = {TRAIN_BATCH: synthetic_batch(cfg, TRAIN_BATCH, KNNLM_PROMPT, seed=seed + 2000,
                                            device=dev)}
    runs = decode_runs(fns, params, rec, tally, prompts, card, tag, gen=TRAIN_DECODE)
    rec.close()
    out["serve"] = {"keys": ds.engine.n_valid, "harvest_s": harvest_s, "build_s": build_s,
                    "build_launches": build_launches,
                    "runs": [r for r, *_ in runs.values()],
                    "peak_gb": gb(torch.cuda.max_memory_allocated())}
    out["launches"] = dict(tally.total)
    tally.discard()
    out["serve"]["exact"] = check_lookups(runs, ds.index, kernels, f"{tag} a.", gen=TRAIN_DECODE)
    tally.discard()
    log(f"{tag} a. from_corpus with the trained weights over {TRAIN_STORE_SEQS} x {TRAIN_SEQ} "
        f"tokens: {ds.engine.n_valid} keys, harvest {harvest_s:.2f} s, build {build_s:.2f} s")
    del ds, rec, runs, params
    torch.cuda.empty_cache()

    # b. restart: a checkpoint at RESTART_AT, a fresh Trainer resumes
    tr1, run1, timed1 = train_run(fns, cfg, data, ckpt_root / "b", RESTART_AT, seed, dev,
                                  ckpt_every=RESTART_AT)
    ck_gb = gb(timed1.step_bytes(RESTART_AT))
    same = [h["loss"] for h in run1["history"]] == losses[:RESTART_AT]
    # where a step's time goes: one more step of this (discarded) run under
    # the profiler
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(RESTART_AT).items()}
    tw["device"] = device_busy(lambda: tr1.train_step(tr1.state, batch), tw["ms_median"], top=8)
    log(f"{tag} a. one train step under the profiler kept the card busy "
        f"{tw['device']['busy_ms']:.1f} ms in {tw['device']['kernels']} device events, "
        f"{tw['device']['busy_share']:.3f} of the {tw['ms_median']:.1f} ms step; top: "
        + "; ".join(f"{n[:48]} {ms_:.1f} ms" for n, ms_ in tw["device"]["top"]))
    del tr1, batch
    torch.cuda.empty_cache()
    tr2, run2, timed2 = train_run(fns, cfg, data, ckpt_root / "b", RESTART_TO, seed, dev)
    resumed = {h["step"]: h["loss"] for h in run2["history"]}
    diff = max(abs(resumed[s] - losses[s - 1]) for s in resumed)
    restore_s = [e["s"] for e in timed2.events if "restore" in e]
    out["restart"] = {"ckpt_gb": ck_gb, "events_first": timed1.events,
                      "events_resumed": timed2.events, "resumed_from": min(resumed) - 1,
                      "max_loss_diff": diff, "first_steps_bit_equal": same,
                      "losses": [resumed[s] for s in sorted(resumed)]}
    log(f"{tag} b. checkpoint at step {RESTART_AT}: {ck_gb:.2f} GB; saves "
        + "; ".join(f"{'blocking' if e.get('block') else 'async'} save of step {e['save']} "
                    f"{e['s']:.2f} s" if "save" in e else f"wait for the async write "
                    f"{e['s']:.2f} s" for e in timed1.events)
        + f"; a fresh Trainer restored step {min(resumed) - 1} in "
        f"{restore_s[0] if restore_s else float('nan'):.2f} s and ran to {RESTART_TO}: max "
        f"|loss - uninterrupted| {diff:.3e} (tolerance {RESTART_LOSS_ATOL}); the first "
        f"{RESTART_AT} steps' losses equal a's bit for bit: {same}; {card}")
    check(min(resumed) == RESTART_AT + 1 and run2["final_step"] == RESTART_TO,
          f"{tag} the second Trainer did not resume from step {RESTART_AT}")
    check(diff <= RESTART_LOSS_ATOL, f"{tag} the resumed run's losses depart from a's")
    del tr2
    shutil.rmtree(ckpt_root / "b")
    torch.cuda.empty_cache()

    # c. gradients on the card against the CPU
    c_cfg = cfg.replace(n_layers=GRAD_LAYERS, dtype="float32")
    c_fns = model_fns(c_cfg)
    on_card = c_fns.init(seed + 1, device=dev).requires_grad_(True)
    on_cpu = copy.deepcopy(on_card).to("cpu")
    batch = SyntheticLM(c_cfg.vocab, GRAD_SEQ, GRAD_BATCH, seed=seed + 1).batch(0)
    t0 = time.perf_counter()
    loss_g, g_card = grads_of(c_fns, c_cfg, on_card, {k: torch.as_tensor(v, device=dev)
                                                       for k, v in batch.items()})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_c, g_cpu = grads_of(c_fns, c_cfg, on_cpu, batch)
    t2 = time.perf_counter()
    loss_t, g_true = grads_of_float64(c_cfg, on_cpu, batch)
    t3 = time.perf_counter()

    def leaf_rel(g_of):
        rel = {n: ((g_of[n].cpu().double() - g).abs().max() / g.abs().max()).item()
               for n, g in g_true.items()}
        return rel, max(rel, key=rel.get)

    rel, worst_leaf = leaf_rel(g_card)
    worst = rel[worst_leaf]
    rel32, worst32 = leaf_rel(g_cpu)
    loss_rel = abs(float(loss_g) - float(loss_t)) / abs(float(loss_t))
    loss_rel32 = abs(float(loss_c) - float(loss_t)) / abs(float(loss_t))
    out["grad_check"] = {"layers": GRAD_LAYERS, "batch": [GRAD_BATCH, GRAD_SEQ],
                         "loss_card": float(loss_g), "loss_cpu_float64": float(loss_t),
                         "loss_rel": loss_rel, "worst_leaf_rel": worst, "worst_leaf": worst_leaf,
                         "leaf_rel": rel, "loss_cpu_float32": float(loss_c),
                         "cpu_float32_loss_rel": loss_rel32,
                         "cpu_float32_worst_leaf_rel": rel32[worst32],
                         "cpu_float32_worst_leaf": worst32,
                         "card_vs_cpu_float32_loss_rel":
                             abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
                         "cpu_threads": torch.get_num_threads(),
                         "card_s": t1 - t0, "cpu_s": t2 - t1, "cpu_float64_s": t3 - t2}
    log(f"{tag} c. {GRAD_LAYERS}-layer float32 copy at full width, B = {GRAD_BATCH}, S = "
        f"{GRAD_SEQ}, against float64 on the CPU: loss card {float(loss_g):.6f}, float64 "
        f"{float(loss_t):.6f} (relative {loss_rel:.2e}, tolerance {GRAD_LOSS_RTOL}); the worst "
        f"leaf's max |grad diff| over its max |grad| {worst:.2e} ({worst_leaf}; tolerance "
        f"{GRAD_RTOL}), the median leaf's {float(np.median(list(rel.values()))):.2e}; a float32 "
        f"CPU run against float64: loss {loss_rel32:.2e}, worst leaf {rel32[worst32]:.2e} "
        f"({worst32}); card {t1 - t0:.2f} s, CPU float32 {t2 - t1:.2f} s, float64 "
        f"{t3 - t2:.2f} s on {torch.get_num_threads()} threads (first call, unwarmed)")
    check(loss_rel <= GRAD_LOSS_RTOL and worst <= GRAD_RTOL,
          f"{tag} the card's gradients depart from the CPU's float64 ones")
    del on_card, on_cpu, g_card, g_cpu, g_true
    torch.cuda.empty_cache()

    # d. int8 compression at full width
    state = init_state(fns, seed + 2, compress_grads=True, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(0).items()}
    _, g = grads_of(fns, cfg, state["params"], batch)
    groups = reference_paths(state["params"], cfg)
    absmax = {}
    for n, t in g.items():
        absmax[groups[n]] = max(absmax.get(groups[n], 0.0), float(t.abs().max()))
    del g
    step_fn = make_train_step(fns, cfg, compress_grads=True)
    state, m = step_fn(state, batch)
    ratio = max(float(e.abs().max()) / (max(absmax[groups[n]], 1e-12) / 127.0)
                for n, e in state["err"].items())
    out["compression"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "max_err_over_scale": ratio, "bound": ERR_HALF_STEP,
                          "scales": len(absmax)}
    log(f"{tag} d. one full-width step with compress_grads: loss {float(m['loss']):.4f}, "
        f"grad_norm {float(m['grad_norm']):.3f}; max |err| / scale over {len(state['err'])} "
        f"leaves ({len(absmax)} scales, one per reference leaf) {ratio:.6f} (bound "
        f"{ERR_HALF_STEP})")
    check(np.isfinite(float(m["loss"])) and ratio <= ERR_HALF_STEP,
          f"{tag} the error feedback exceeds the quantizer's half step")
    del state, step_fn, batch
    torch.cuda.empty_cache()

    # e. one train step of each family at full width and depth
    out["families"] = {}
    for i, arch in enumerate(FAMILY_ARCHS):
        torch.cuda.reset_peak_memory_stats()
        f_cfg = ARCHS[arch]
        f_fns = model_fns(f_cfg)
        seq = min(FAMILY_LEN, f_cfg.max_seq_len)
        t0 = time.perf_counter()
        state = init_state(f_fns, seed + 20 + i, device=dev)
        batch = synthetic_batch(f_cfg, FAMILY_TRAIN_BATCH, seq, seed=seed + 30 + i, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _, g = grads_of(f_fns, f_cfg, state["params"], batch)
        missing = [n for n, t in g.items() if t is None]
        finite = all(t is not None and bool(torch.isfinite(t).all()) for t in g.values())
        router = {n: float(t.abs().max()) for n, t in g.items()
                  if n.endswith("moe.router") and t is not None}
        del g
        step_fn = make_train_step(f_fns, f_cfg, lr_schedule=functools.partial(
            schedule.constant, peak_lr=TRAIN_LR))
        ms, mets = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append({k: float(v) for k, v in m.items()})
        r = out["families"][arch] = {
            "seq": seq, "params_gb": gb(sum(p.numel() * 4 for p in state["params"].parameters())),
            "init_s": init_s, "step_ms": ms, "losses": [x["loss"] for x in mets],
            "grad_norms": [x["grad_norm"] for x in mets], "missing_grads": missing,
            "grads_finite": finite, "router_grad_max": min(router.values()) if router else None,
            "peak_gb": gb(torch.cuda.max_memory_allocated())}
        log(f"{tag} e. {arch} ({f_cfg.n_layers} layers, d {f_cfg.d_model}, {r['params_gb']:.2f} "
            f"GB of fp32 params) at B = {FAMILY_TRAIN_BATCH}, S = {seq}: steps "
            f"{ms[0]:.0f} / {ms[1]:.0f} ms, loss {r['losses'][0]:.4f} -> {r['losses'][1]:.4f}, "
            f"grad_norm {r['grad_norms'][0]:.3f}; every parameter a finite gradient: "
            f"{finite and not missing}"
            + (f"; the smallest max |router grad| over its layers {r['router_grad_max']:.3e}"
               if router else "") + f"; peak {r['peak_gb']:.2f} GB; {card}")
        check(not missing and finite and all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                                             for x in mets),
              f"{tag} {arch}: a gradient is missing or not finite")
        check(not router or r["router_grad_max"] > 0, f"{tag} {arch}: a router gets no gradient")
        check(r["losses"][1] < r["losses"][0],
              f"{tag} {arch}: a second step did not lower the loss")
        del state, batch, step_fn
        torch.cuda.empty_cache()

    out["seconds"] = time.perf_counter() - t_phase
    for name in path:
        check(out["launches"][name] > 0, f"phase 14's path never launched {name}")
    log(f"{tag} phase 14 on {card}: launches {out['launches']}, {out['seconds']:.1f} s")
    return out


def small_batch_merge(eng, q64, _launch, _operands, merge_splits):
    """pruned_topk's fused merge at one query tile (each of MERGE_TILE_ROWS
    queries, k = 10) on ``eng``'s index, at the splits the engine chooses
    there: merge_routes' clock of the epilogue and its tail, and the three
    routes in turns."""
    from repro_torch.search.backends import kernel_inputs, prep_queries

    out = {}
    for m in MERGE_TILE_ROWS:
        qn, qp = prep_queries(eng.index, q64[:m])
        a_k, kw_k, perm = kernel_inputs(
            eng.index, qn, qp, 10, bm=eng.bm, bn=eng.bn, warm_start=eng.warm_start,
            best_first=eng.best_first, margin=eng.margin,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
        ops_m, kw_m = _operands(*a_k, **dict(kw_k, row_out=perm))
        old, times = merge_routes(_launch, merge_splits, ops_m, kw_m, perm)
        new = _launch(*ops_m, **kw_m)
        equal = torch.equal(old[0], new.sims) and torch.equal(old[1], new.idx)
        out[m] = {"splits": kw_k["splits"], "equal_to_old_route": equal, **times}
        log(f"[serve] pruned_topk at one query tile of {m} (k = 10, {kw_k['splits']} "
            f"splits): the epilogue's merge {times['epilogue_us_median']:.1f} us, its tail "
            f"past the last arrival {times['epilogue_tail_us']:.1f} us; in turns: fused "
            f"{times['fused_ms']:.3f} ms, unfused {times['unfused_ms']:.3f} ms, unfused + "
            f"merge_splits + gathers {times['old_route_ms']:.3f} ms; equal to the old "
            f"route: {equal}")
        check(equal, f"pruned_topk's merge at m = {m} differs from the old route")
        del ops_m, kw_m, old, new
    return out


def profile_search(eng, q, k, matrix_elems, top=12):
    """One torch.profiler window over a warm ``search`` call: the device
    operations that took the most time in it (self time on the card), and
    every ``aten::sort`` with its input shape.  Fails if one of them sorts
    ``matrix_elems`` or more keys (the [M, NB] bound matrix), if a
    ``merge_splits_kernel`` ran, or if other than two sorts of the [M]
    queries ran (the query sort's two; pruned_topk writes the rows back,
    so none undoes it)."""
    from torch.profiler import ProfilerActivity, profile

    eng.search(q, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        eng.search(q, k)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def device_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        return us / 1e3

    ops = [(e.key, device_ms(e), e.count) for e in prof.key_averages()
           if device_ms(e) > 0]
    ops.sort(key=lambda x: -x[1])
    total = sum(x[1] for x in ops)
    if not ops:
        log(f"[profile] search k={k}: the profiler shows no device time "
            f"(wall {wall_ms:.3f} ms under the profiler)")
    else:
        log(f"[profile] search k={k}: {total:.3f} ms of device time in "
            f"{len(ops)} operations, wall {wall_ms:.3f} ms under the profiler; top: "
            + "; ".join(f"{name[:70]} x{n}: {ms:.3f} ms" for name, ms, n in ops[:top]))
    sorts = [{"shape": list(e.input_shapes[0]) if e.input_shapes else [],
              "count": e.count}
             for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::sort"]
    m = q.shape[0]
    query_sorts = sum(x["count"] for x in sorts if x["shape"] == [m])
    gathers = sum(e.count for e in prof.key_averages() if e.key == "aten::index")
    merges = [n for n, _, _ in ops if "merge_splits_kernel" in n]
    log(f"[profile] aten::sort calls by input shape: {sorts}; sorts of [{m}]: "
        f"{query_sorts}; aten::index calls: {gathers}; merge_splits_kernel: "
        f"{len(merges)}")
    check(all(int(np.prod(x["shape"])) < matrix_elems for x in sorts),
          f"a search call sorts the {matrix_elems}-element bound matrix: {sorts}")
    check(not merges, f"a search call launched merge_splits_kernel: {merges}")
    check(query_sorts == 2, f"a search call sorts [{m}] {query_sorts} times, not 2")
    return {"wall_ms": wall_ms, "device_ms": total, "sorts": sorts,
            "query_sorts": query_sorts, "index_calls": gathers,
            "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in ops[:top]]}


def compare_topk(got, want, tol, margin, gaps=None):
    """Kernel vs plain pruned_topk outputs: max |sim diff| over finite
    slots, tie-aware id sets, computed/elem agreement.

    The bounds of both versions are equal bit for bit, but τ is a running
    k-th best score, summed by the two in another order.  So a computed
    flip is explained only where the plain version's ``gaps`` show that
    tile's decision within 2·margin of τ, and an element count may differ
    only by the tile's elements that lie that close; without ``gaps`` no
    difference is explained."""
    s_g, i_g, c_g, e_g = [None if x is None else x.cpu().numpy() for x in got]
    s_w, i_w, c_w, e_w = [None if x is None else x.cpu().numpy() for x in want]
    fin = np.isfinite(s_w)
    same_inf = bool((np.isfinite(s_g) == fin).all())
    err = float(np.abs(s_g[fin] - s_w[fin]).max()) if fin.any() else 0.0
    bad = tie_aware_mismatches(np.where(fin, s_g, -9), np.where(fin, i_g, -1),
                               np.where(fin, s_w, -9), np.where(fin, i_w, -1), tol)
    flip = c_g != c_w
    elem_diff = np.zeros_like(c_w) if e_w is None else np.abs(e_g - e_w)
    if gaps is None:
        flip_ok, near = np.zeros_like(flip), np.zeros_like(elem_diff)
    else:
        gap, near = (x.cpu().numpy() for x in gaps)
        flip_ok = np.abs(gap) <= 2 * margin
    minus_one = bool((i_g[~np.isfinite(s_g)] == -1).all())
    return dict(max_abs_err=err, ids_equal=bad == 0 and same_inf,
                computed_equal=not flip.any(), computed_flips=int(flip.sum()),
                flips_unexplained=int((flip & ~flip_ok).sum()),
                elem_abs_diff=int(elem_diff.sum()),
                elem_unexplained=int(np.maximum(elem_diff - near, 0).sum()),
                empty_slots_minus_one=minus_one, tiles=int(c_w.size))


def check_topk(got, want, args, kwargs, tol, pruned_topk_plain):
    """compare_topk; where computed or elem differ, run the plain version
    again with its decision gaps to tell fp32 noise from a fault."""
    margin = kwargs.get("margin", 4e-7)
    r = compare_topk(got, want, tol, margin)
    if r["computed_flips"] or r["elem_abs_diff"]:
        *want, gap, near = pruned_topk_plain(*args, gaps=True, **kwargs)
        r = compare_topk(got, want, tol, margin, gaps=(gap, near))
    return r


def topk_ok(r, tol):
    return (r["max_abs_err"] <= tol and r["ids_equal"] and r["empty_slots_minus_one"]
            and r["flips_unexplained"] == 0 and r["elem_unexplained"] == 0)


def pruned_topk_costs(args, kwargs, computed):
    """The least bytes and operations of this pruned_topk call on these
    inputs: each input read once (db rows only of tiles some query tile
    computes, at the db's element size: 2 B for a bf16 db), each output
    written once; score flops only for computed
    (query tile, db tile) pairs, bound operations for every pair."""
    qn, db, qp, lo, hi, _ = args
    m, d = qn.shape
    p, bm, bn, k = qp.shape[1], kwargs["bm"], kwargs["bn"], kwargs["k"]
    mt, nt = computed.shape
    rows = torch.full((mt,), bm, dtype=torch.float64)
    rows[-1] = m - (mt - 1) * bm
    comp = computed.cpu().double()
    flops = 2.0 * bn * d * float((comp * rows[:, None]).sum())
    ops = flops + eq13_ops(m, nt, p) + float(m) * nt * SKIP_OPS
    used_tiles = int((comp.sum(0) > 0).sum())
    nbytes = 4 * (m * d + m * p + 2 * nt * p + m + mt * nt) + db.shape[0] \
        + db.element_size() * used_tiles * bn * d + 8 * m * k + 4 * mt * nt
    if kwargs.get("ub_cap") is not None:
        nbytes += 4 * m * nt
        ops += float(m) * nt
    return nbytes, ops


def eq13_ops(m, nb, p):
    """The least operations of the Eq. 13 interval bound, min over p
    pivots, of m queries against nb blocks."""
    return (float(m) * nb * p * BOUND_OPS_QBP + float(nb) * p * BOUND_OPS_BP
            + float(m) * p * BOUND_OPS_QP)


def bound_entry(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def merge_routes(_launch, merge_splits, ops, kw, perm):
    """pruned_topk's merge by three routes on the same operands, timed in
    MERGE_TURNS turns (the order rotated each turn): ``fused``, the kernel
    with its epilogue and ``row_out = perm``; ``unfused``, the kernel
    without it; ``old_route``, that kernel + merge_splits (at splits > 1)
    + the gathers by argsort(perm), the engine's route before the
    epilogue.  The kernel's calls spread by more than a merge takes, so
    direct times come with the paired ones: from the clock each fused
    launch leaves (``merge_clock``), each query tile's merge and the tail
    it adds to the kernel (the last merge's end past the last arrival),
    and the old route's merge, argsort and gathers alone on the same
    partial lists.  Returns the old route's (sims, ids) and the times."""
    unfused = dict(kw, row_out=None, fused=False)

    def old_merge(part_s, part_i):
        inv = torch.argsort(perm)
        top = merge_splits(part_s, part_i) if kw["splits"] > 1 else (part_s[0], part_i[0])
        return top[0][inv], top[1][inv]

    def old_route():
        out = _launch(*ops, **unfused)
        return old_merge(out.part_s, out.part_i)

    clocks = []

    def fused():
        clocks.append(_launch(*ops, **kw).merge_clock)

    old = old_route()
    routes = {"fused": fused, "unfused": lambda: _launch(*ops, **unfused),
              "old_route": old_route}
    names = list(routes)
    ms = {name: [] for name in names}
    for t in range(MERGE_TURNS):
        for name in names[t % 3:] + names[:t % 3]:
            ms[name] += cuda_ms(routes[name], 1)
    out = _launch(*ops, **unfused)
    alone = cuda_ms(lambda: old_merge(out.part_s, out.part_i), MERGE_TURNS)
    clock = torch.stack(clocks).long().cpu()              # [turns, 3, mt]
    ns = clock[:, 0].double()
    # the low 32 bits of the ns clock, relative to each launch's first
    # arrival (a launch lasts far less than 2^31 ns)
    rel = (clock[:, 1:] - clock[:, 1:2, :1]) % 2**32
    rel = torch.where(rel >= 2**31, rel - 2**32, rel).double()
    tail = rel[:, 1].amax(1) - rel[:, 0].amax(1)
    times = {f"{name}_minus_unfused_ms": float(np.median(np.subtract(
        ms[name], ms["unfused"]))) for name in ("fused", "old_route")}
    times.update({f"{name}_ms": float(np.median(v)) for name, v in ms.items()},
                 ms=ms, old_merge_alone_ms=float(np.median(alone)),
                 epilogue_us_median=float(ns.median()) / 1e3,
                 epilogue_us_max=float(ns.amax(1).median()) / 1e3,
                 epilogue_tail_us=float(tail.median()) / 1e3,
                 epilogue_tail_us_all=(tail / 1e3).tolist())
    return old, times


#: phase 15, the sharded search layer: phase 3's corpus split into this
#: many shards, all on the one card (147,940 rows and 1,156 blocks a shard)
SHARDED_SHARDS = 8
#: phase 15c: rows a shape-stable insert takes, ids a delete takes, rounds
#: of the two, and the queries each mutation's search is held to the live
#: brute force with
SHARDED_INSERT, SHARDED_DELETE, SHARDED_ROUNDS, SHARDED_QUERIES = 16, 4, 3, 1000


def sharded_searches(label, sh, q, spec, kernels, want_per_call, scans, kept=None):
    """Phase 15a / 15b at each k of the spec on the sharded engine ``sh``: a
    warm-up, REPS timed calls (CUDA events), one more and one under the
    profiler, every launch of ``kernels`` counted over them and held to
    ``want_per_call(k, stats)`` per call, and no scan (``scans`` counts
    them).  ``kept`` (a list the tree's kernel leaf stage appends each
    shard's kept blocks to) gives the last call's kept blocks per shard.
    Returns ({k: report}, {k: (sims, ids)})."""
    out, results = {}, {}
    for k in spec["ks"]:
        before = [kern.launches for kern in kernels]
        n_scans = len(scans)
        sh.search(q, k)                                    # warm-up
        ms = cuda_ms(lambda: sh.search(q, k), REPS)
        if kept is not None:
            kept.clear()
        sims, ids, st = sh.search(q, k)
        n_kept = list(kept) if kept is not None else None
        p50 = float(np.median(ms))
        profile = device_busy(lambda: sh.search(q, k), p50, top=6)
        n_calls = REPS + 3
        seen = {kern.__name__: kern.launches - b for kern, b in zip(kernels, before)}
        want = {name: n * n_calls for name, n in want_per_call(k, st).items()}
        check(all(seen[name] == want.get(name, 0) for name in seen),
              f"sharded {label} k={k}: launches {seen} in {n_calls} calls, want {want}")
        check(len(scans) == n_scans, f"sharded {label} k={k}: the scan ran")
        results[k] = (sims, ids)
        r = {"p50_ms": p50, "qps": spec["m"] / (p50 / 1e3), "ms": ms,
             "block_prune_frac": float(st.block_prune_frac),
             "tile_computed_frac": float(st.tile_computed_frac),
             "launches": seen, "calls": n_calls, "profile": profile}
        if st.tree_prune_frac is not None:
            r.update(tree_prune_frac=float(st.tree_prune_frac),
                     tree_node_eval_frac=float(st.tree_node_eval_frac),
                     tree_levels=st.extras["tree_levels"], kept_blocks=n_kept)
        out[k] = r
    return out, results


def sharded_online(tr, q, spec, seed, kernels, levels_of):
    """Phase 15c: the tree engine's ShardedMutableIndex (its own copy of
    the index) through SHARDED_ROUNDS rounds of {insert SHARDED_INSERT
    mixture rows, delete SHARDED_DELETE live ids}, one insert of one row
    more than every free slot (one block appended to every shard), and one
    reoptimize.  After every mutation the search at k = 10 of the first
    SHARDED_QUERIES queries is held to LiveRows.matches, with 8 pruned_topk
    and 8 x (levels_of(stats) + 1) block_bounds launches; after the first
    insert the widened shard trees equal build_shard_trees bit for bit."""
    from repro_torch.search import build_shard_trees

    pruned_topk, select, block_bounds = kernels[0], kernels[1], kernels[2]
    t0 = time.perf_counter()
    h = tr.online(auto_reoptimize=False)
    handle_s = time.perf_counter() - t0
    live = LiveRows(tr.index, spec["n"] + 10_000)
    rng = np.random.default_rng(seed + 15)
    centres = mixture_centres(spec, seed)
    qs = q[:SHARDED_QUERIES]
    out = {"handle_s": handle_s, "insert_us": [], "delete_us": [], "steps": []}

    def timed(op, *arg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = getattr(h, op)(*arg)
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t) * 1e6

    def search(label):
        for kern in kernels:
            kern.launches = 0
        sims, ids, st = tr.search(qs, 10)
        torch.cuda.synchronize()
        seen = {kern.__name__: kern.launches for kern in kernels}
        want = {pruned_topk.__name__: SHARDED_SHARDS,
                block_bounds.__name__: SHARDED_SHARDS * (levels_of(st) + 1)}
        check(all(seen[name] == want.get(name, 0) for name in seen),
              f"sharded online {label}: launches {seen}, want {want}")
        ok, err_b, err_t = live.matches(qs, sims, ids, 10)
        check(ok, f"sharded online {label}: not the brute force over the live rows "
                  f"(max |sim - brute| {err_b:.3e}, |sim - true| {err_t:.3e})")
        out["steps"].append({"step": label, "max_err_vs_brute": err_b, "launches": seen,
                             "n_live": h.n_live, "n_blocks": tr.n_blocks,
                             "index_epoch": tr.index_epoch,
                             "tree_prune_frac": float(st.tree_prune_frac),
                             "block_prune_frac": float(st.block_prune_frac)})

    search("start")
    for r in range(SHARDED_ROUNDS):
        rows = mixture_draw(rng, centres, SHARDED_INSERT, spec["noise"])
        ids, us = timed("insert", rows)
        out["insert_us"].append(us)
        live.insert(ids, rows)
        check(tr.index_epoch == 0, "a 16-row sharded insert changed the shape")
        if r == 0:
            same = all(torch.equal(a, b) for a, b in zip(tr._shard_tree,
                                                          build_shard_trees(tr.index)))
            out["widened_equals_rebuilt"] = same
            check(same, "the widened shard trees differ from build_shard_trees")
        search(f"insert {r}")
        dead = rng.choice(live.live_ids(), SHARDED_DELETE, replace=False).tolist()
        _, us = timed("delete", dead)
        out["delete_us"].append(us)
        live.delete(dead)
        search(f"delete {r}")
    free = sum(len(f) for f in h._free)
    rows = mixture_draw(rng, centres, free + 1, spec["noise"])
    ids, us = timed("insert", rows)
    out["grow_insert"] = {"rows": free + 1, "us": us}
    live.insert(ids, rows)
    check(tr.index_epoch == 1 and tr.n_blocks == out["steps"][0]["n_blocks"] + 1,
          f"the insert past every tail left epoch {tr.index_epoch}, {tr.n_blocks} blocks")
    search("grow")
    _, us = timed("reoptimize")
    out["reoptimize_s"] = us / 1e6
    search("reoptimize")
    out["placed_per_shard"] = np.bincount([s for s, _ in h._id_pos.values()],
                                          minlength=SHARDED_SHARDS).tolist()
    return out


def phase_sharded(spec, seed, eng, q, brute, SearchEngine, kernels, card):
    """Phase 15: the sharded search layer on the card.  Phase 3's corpus
    (``synth(spec, seed)``) is built as SHARDED_SHARDS shards on a one-rank
    CUDA ``DeviceMesh`` in this process (a NCCL group of one through a file
    store under build/; no collective runs with one rank) through
    ``SearchEngine.build(db, mesh=..., n_shards=...)``.  ``kernels`` is
    (pruned_topk, block_bounds_select, block_bounds, merge_splits), their
    counts zeroed before the build; the scan (``backends.scan_search``) is
    counted for the phase and must not run.

    a. flat (``tree_shards=False``): every call launches pruned_topk and
       block_bounds_select once per shard and the others never;
    b. the shard trees, an engine on the same index with ``tree_shards``
       left to the auto rule (trees from 256 blocks a shard): every call
       launches per shard one pruned_topk (the kernel leaf stage's
       gathered_topk) and the descent's levels + 1 block_bounds (the
       levels read off the shard trees' heap), no select kernel;
    c. the tree engine's online handle (sharded_online).

    15a and 15b run at the spec's ks (sharded_searches), every answer held
    to phase 3's brute force (``brute``) and to phase 3's single-device
    engine ``eng`` (tie-aware within 1e-5), which is timed and profiled
    again here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.cosine_topk import default_splits
    from repro_torch.search import backends
    from repro_torch.search import tree as t_tree

    t_phase = time.perf_counter()
    pruned_topk, select, block_bounds = kernels[0], kernels[1], kernels[2]
    db_np, _ = synth(spec, seed)
    store = ROOT / "build" / "sharded_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    scans, kept = [], []
    scan_search, tree_kernel_search = backends.scan_search, t_tree.tree_kernel_search

    def counted_scan(*a, **kw):
        scans.append(1)
        return scan_search(*a, **kw)

    def recorded_leaves(*a, **kw):
        res = tree_kernel_search(*a, **kw)
        kept.append(int(res[-1].numel()))
        return res

    out = {"shards": SHARDED_SHARDS, "card": card}
    for kern in kernels:
        kern.launches = 0
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    backends.scan_search, t_tree.tree_kernel_search = counted_scan, recorded_leaves
    try:
        torch.cuda.set_device(0)
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("shard",))
        torch.cuda.synchronize()
        out["resident_before_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sh = SearchEngine.build(db_np, mesh=mesh, n_shards=SHARDED_SHARDS, n_pivots=16,
                                block_size=128, tree_shards=False)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        out["index_gb"] = sum(t.numel() * t.element_size() for t in sh.index
                              if t is not None) / 1e9
        out["rows_per_shard"] = -(-spec["n"] // SHARDED_SHARDS)
        out["padded_rows_per_shard"] = int(sh.index.db.shape[1])
        out["n_blocks_per_shard"] = sh.n_blocks
        check(sh.backend_name == "sharded" and sh.index.db.shape[0] == SHARDED_SHARDS
              and sh.n_valid == spec["n"] and not sh._tree_shards_enabled,
              f"sharded engine: {sh.backend_name}, {tuple(sh.index.db.shape)}, "
              f"{sh.n_valid} valid rows, shard trees {sh._tree_shards_enabled}")
        flat_calls = {pruned_topk.__name__: SHARDED_SHARDS, select.__name__: SHARDED_SHARDS}
        out["flat"], results = sharded_searches("flat", sh, q, spec, kernels,
                                                lambda k, st: flat_calls, scans)

        # b. the shard trees by the auto rule, on the same index
        tr = SearchEngine(sh.index, mesh=mesh)
        check(tr.tree_shards is None and tr._tree_shards_enabled,
              f"the auto rule left the shard trees off at {tr.n_blocks} blocks a shard")
        t0 = time.perf_counter()
        tree = backends.get_backend("sharded")._shard_tree(tr)
        torch.cuda.synchronize()
        out["tree_build_s"] = time.perf_counter() - t0
        levels = (tree.node_valid.shape[1] // 2).bit_length() - 1
        out["tree_levels"] = levels

        def tree_calls(k, st):
            check(st.extras["tree_levels"] == levels, "the shard trees' depth changed")
            return {pruned_topk.__name__: SHARDED_SHARDS,
                    block_bounds.__name__: SHARDED_SHARDS * (levels + 1)}

        out["trees"], tree_results = sharded_searches("trees", tr, q, spec, kernels,
                                                      tree_calls, scans, kept)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ab = {kern.__name__: kern.launches for kern in kernels}

        # c. mutation through the tree engine's handle
        out["online"] = sharded_online(tr, q, spec, seed, kernels,
                                       lambda st: st.extras["tree_levels"])
        out["launches"] = {name: ab[name] + sum(s["launches"].get(name, 0)
                                                for s in out["online"]["steps"])
                           for name in ab}
        # the shard trees' pruned_topk launches are gathered_topk's (15b, 15c)
        out["gathered_launches"] = (
            sum(r["launches"][pruned_topk.__name__] for r in out["trees"].values())
            + sum(s["launches"][pruned_topk.__name__] for s in out["online"]["steps"]))
        out["scan_calls"] = len(scans)
        out["search_calls"] = sum(r["calls"] for part in ("flat", "trees")
                                  for r in out[part].values()) + len(out["online"]["steps"])
        check(not scans, f"the sharded search ran the scan {len(scans)} times")
    finally:
        backends.scan_search, t_tree.tree_kernel_search = scan_search, tree_kernel_search
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    # every answer against phase 3's brute force and single-device engine;
    # that engine timed and profiled again here, beside the shards
    m, d = q.shape
    out["splits"] = {"per_shard": default_splits(
        m, out["padded_rows_per_shard"], d, 16, bm=sh.bm, bn=128, device=q.device),
        "single": default_splits(m, eng.index.db.shape[0], d, 16, bm=eng.bm, bn=128,
                                 device=q.device)}
    for k in spec["ks"]:
        eng.search(q, k)                                   # warm-up
        single_ms = cuda_ms(lambda: eng.search(q, k), REPS)
        single_p50 = float(np.median(single_ms))
        out[f"single_k{k}"] = {"p50_ms": single_p50, "ms": single_ms,
                               "profile": device_busy(lambda: eng.search(q, k), single_p50,
                                                      top=6)}
        s1, i1, _ = eng.search(q, k)
        s1, i1 = s1.cpu().numpy(), i1.cpu().numpy()
        for part, res in (("flat", results), ("trees", tree_results)):
            name = f"sharded {part} k{k}"
            sims, ids = res[k]
            r = out[part][k]
            r["max_abs_err_vs_brute"] = exactness(spec, name, k, sims, ids, brute)[0]
            s_g, i_g = sims.cpu().numpy(), ids.cpu().numpy()
            err = float(np.abs(s_g - s1).max())
            bad = tie_aware_mismatches(s_g, i_g, s1, i1, 1e-5)
            r.update(max_abs_err_vs_single=err, rows_differing_vs_single=bad)
            log(f"[sharded] {name} vs the single-device engine: max |sim diff| {err:.3e}, "
                f"rows differing beyond near-ties: {bad}")
            check(err <= 1e-5 and bad == 0, f"{name} differs from the single-device engine")
    del results, tree_results
    out["seconds"] = time.perf_counter() - t_phase

    def top(profile):
        return [(name.replace("(anonymous namespace)::", "").removeprefix("void ")
                 .split("(")[0][:48], round(ms, 3)) for name, ms in profile["top"]]

    for k in spec["ks"]:
        single = out[f"single_k{k}"]
        for part in ("flat", "trees"):
            r = out[part][k]
            tree_said = ("" if part == "flat" else
                         f", tree_prune_frac {r['tree_prune_frac']:.4f}, tree_node_eval_frac "
                         f"{r['tree_node_eval_frac']:.4f}, kept blocks per shard "
                         f"{r['kept_blocks']} of {out['n_blocks_per_shard']}")
            log(f"[sharded] 15{'a' if part == 'flat' else 'b'} {part} k = {k} on {card}: "
                f"p50 {r['p50_ms']:.3f} ms (single device {single['p50_ms']:.3f}), QPS "
                f"{r['qps']:.1f}, block_prune_frac {r['block_prune_frac']:.4f}{tree_said}; "
                f"card busy {r['profile']['busy_ms']:.3f} ms "
                f"({single['profile']['busy_ms']:.3f}); launches {r['launches']} in "
                f"{r['calls']} calls")
            log(f"[sharded] 15{'a' if part == 'flat' else 'b'} {part} k = {k}: top device "
                f"events (ms) {top(r['profile'])}")
        log(f"[sharded] single device k = {k}: top device events (ms) {top(single['profile'])}")
    on = out["online"]
    log(f"[sharded] 15c online on {card}: handle {on['handle_s']:.3f} s; insert of "
        f"{SHARDED_INSERT} rows {[round(u, 1) for u in on['insert_us']]} us, delete of "
        f"{SHARDED_DELETE} {[round(u, 1) for u in on['delete_us']]} us; insert of "
        f"{on['grow_insert']['rows']} rows past every tail {on['grow_insert']['us']:.1f} us; "
        f"reoptimize {on['reoptimize_s']:.3f} s; every search exact against the live rows "
        f"(max |diff| {max(s['max_err_vs_brute'] for s in on['steps']):.2e}); rows per shard "
        f"{on['placed_per_shard']}")
    log(f"[sharded] phase 15 on {card}: {SHARDED_SHARDS} shards of "
        f"{out['rows_per_shard']:,} rows ({out['n_blocks_per_shard']:,} blocks, shard trees "
        f"of {out['tree_levels']} levels built in {out['tree_build_s']:.3f} s) on a one-rank "
        f"CUDA mesh; build {out['build_s']:.2f} s; peak {out['peak_gb']:.2f} GB "
        f"({out['resident_before_gb']:.2f} GB resident before, the index "
        f"{out['index_gb']:.2f} GB); launches {out['launches']} in {out['search_calls']} "
        f"calls, scan calls {out['scan_calls']}; splits {out['splits']}; "
        f"{out['seconds']:.1f} s")
    return out


#: phase 16: tinyllama-1.1b at full width and depth on a one-rank mesh,
#: MESH_STEPS steps at B = MESH_BATCH, S = MESH_SEQ, losses within
#: MESH_LOSS_RTOL of the host path's at every step; granite-moe-1b-a400m
#: at full width, B = MESH_MOE_BATCH, S = MESH_MOE_SEQ, through
#: _moe_sharded; the sharded search over ("pod", "data") at MESH_SEARCH
MESH_ARCH, MESH_MOE_ARCH = "tinyllama-1.1b", "granite-moe-1b-a400m"
MESH_STEPS, MESH_BATCH, MESH_SEQ, MESH_LOSS_RTOL = 5, 8, 1024, 1e-5
MESH_MOE_BATCH, MESH_MOE_SEQ = 2, 1024
MESH_SEARCH = dict(n=200_000, d=64, m=1_000, k=10, centers=64, noise=0.05, shards=4)
#: phase 16e: MESH_ARCH's first block at full width, its attention and its
#: MLP computed as each share of "model" for each tp in MESH_SPLIT_TPS at
#: B = MESH_BATCH, S = MESH_SEQ; the shares' sums against the whole layer
#: within MESH_SPLIT_RTOL of each tensor's largest magnitude, by activation
#: dtype (bf16: each share's output and gradients are rounded to bf16 apart
#: before the sum, a few bf16 steps; fp32: the sums' order)
MESH_SPLIT_TPS = (2, 4, 16)
MESH_SPLIT_RTOL = {"bfloat16": 3e-2, "float32": 1e-4}
#: phase 16e also: rwkv6-1.6b's first block (its time mix and its channel
#: mix) and zamba2-1.2b's first Mamba2 layer, the same way; phase 16a: a
#: one-rank mesh train step of each at full width and the depth given
#: (zamba2's keeps one shared block), bit for bit with the host path
MESH_RECURRENT_LAYERS = {"rwkv6-1.6b": 4, "zamba2-1.2b": 6}
#: their shares' sums against the whole, by activation dtype: fp32 is
#: looser than MESH_SPLIT_RTOL's, since these layers' gradients move with
#: the rounding of the shares' smaller GEMMs more than attention's do (the
#: time mix's per-head norm divides outputs near 0; the SSD's A_log and
#: dt_bias gradients sum every token's decay): up to 1.1e-4 read on an
#: H100; each row prints the whole layer's own change under a one-ulp
#: perturbation of its input beside it
MESH_RECURRENT_RTOL = {"bfloat16": 3e-2, "float32": 1e-3}
#: phase 16e: MESH_ARCH's head (its own lm_head.w, then tied to the
#: embedding) and the vocab-parallel loss at B = MESH_BATCH, S = MESH_SEQ
#: over each tp of MESH_SPLIT_TPS: the shares' logits, hidden-state and
#: weight gradients within MESH_SPLIT_RTOL of the whole head's largest
#: magnitude; the loss combined by hand from the shares within this of
#: chunked_ce's on the whole logits, relative (bf16: each share's logits
#: are a GEMM of their own, rounded to bf16 apart; fp32: the sums' order)
MESH_HEAD_LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-5}


def leaf_placements(model):
    """Each parameter's placement as ``pattern: (count, local shape, global
    shape, placements)``, the pattern its name with the layer index as *."""
    from repro_torch.dist import placement

    out = {}
    for name, (loc, glob, placed) in placement.describe(model).items():
        key = ".".join("*" if part.isdigit() else part for part in name.split("."))
        n = out.get(key, (0,))[0]
        out[key] = (n + 1, list(loc), list(glob), placed)
    return out


def mesh_host_steps(fns, cfg, seed, batches, dev, schedule_fn):
    """MESH_STEPS host steps of a fresh state; (losses, ms, the parameters
    after, on the host)."""
    from repro_torch.train.train_step import init_state, make_train_step

    state = init_state(fns, seed, device=dev)
    step = make_train_step(fns, cfg, lr_schedule=schedule_fn)
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    params = {n: p.detach().cpu() for n, p in state["params"].named_parameters()}
    return losses, ms, params


def mesh_steps(fns, cfg, seed, batches, mesh, schedule_fn):
    """:func:`mesh_host_steps` on the one-rank ``mesh`` ("data", "model")
    under default_rules(fsdp=True): the state placed by
    launch.dryrun.param_shardings (place_state), each batch a DTensor
    (make_process_local_array, the launcher's make_global), the mesh train
    step; (losses, ms, the parameters after, on the host, the leaves'
    placements)."""
    from repro_torch.dist import placement
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.compat import make_process_local_array
    from repro_torch.launch.dryrun import param_shardings
    from repro_torch.train.train_step import init_state, make_train_step, place_state

    shd.set_rules(mesh, shd.default_rules(fsdp=True))
    try:
        state = init_state(fns, seed, device=placement.local_device(mesh))
        state = place_state(state, param_shardings(state["params"], mesh, cfg))
        placed = leaf_placements(state["params"])
        step = make_train_step(fns, cfg, lr_schedule=schedule_fn)
        batch_sh = shd.NamedSharding(mesh, (("data",),))
        losses, ms = [], []
        for b in batches:
            gb_ = {k: make_process_local_array(batch_sh, x, x.shape) for k, x in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, gb_)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
    finally:
        shd.set_rules(None, None)
    params = {n: placement.local(p).detach().cpu() for n, p in state["params"].named_parameters()}
    return losses, ms, params, placed


def split_shares(layer, fn, x, dy, parts):
    """``fn`` (a layer's ``x -> y``) forward and backward against ``dy``
    once per share in ``parts`` (``(r, tp, None)`` under
    ``placement.model_split``, None for the whole layer): (the outputs
    summed, the input's gradient summed, each parameter's gradient summed,
    the FLOPs of each share, forward and backward), in float32 or wider.

    A share whose compute sums a statistic over its group
    (``placement.sum_over_group``: the SSD's gate norm) cannot run alone.
    Its FLOPs are counted with its own term as the sum; its values come
    from every share run against the group's sum, fed by hand
    (``placement.fed_sums``): a pass without gradients adds up the shares'
    terms, a second runs each share against that sum, held as a leaf, and
    once all have run the leaf's gradient, which is the group's, is pushed
    back into each share's term (the all-reduce forward and backward)."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import placement

    def wide(t):
        return t.detach().to(torch.promote_types(t.dtype, torch.float32))

    for w in layer.parameters():
        w.grad = None
    xg = x.detach().clone().requires_grad_(True)

    def run(part, feed):
        split = placement.model_split(part=part) if part else contextlib.nullcontext()
        with split, placement.fed_sums(feed):
            return fn(xg)

    total, flops, summed = None, [], []
    for part in parts:
        with FlopCounterMode(display=False) as fc:
            y = run(part, lambda t: summed.append(True) or t)
            torch.sum(y * dy).backward()
        flops.append(fc.get_total_flops())
        total = wide(y) if total is None else total + wide(y)
    if summed:
        # the group's sums by hand: every share's terms, then every share
        # against them
        for w in layer.parameters():
            w.grad = None
        xg.grad = None
        sums = []
        with torch.no_grad():
            for part in parts:
                terms = []
                run(part, lambda t: terms.append(t) or t)
                sums = [a + b for a, b in zip(sums, terms)] if sums else terms
        leaves = [t.clone().requires_grad_(True) for t in sums]
        own, total, loss = [], None, 0
        for part in parts:
            calls = iter(range(len(leaves)))

            def feed(t):
                k = next(calls)
                own.append((t, k))
                return leaves[k]

            y = run(part, feed)
            loss = loss + torch.sum(y * dy)
            total = wide(y) if total is None else total + wide(y)
        dsum = torch.autograd.grad(loss, leaves, retain_graph=True)
        (loss + sum(torch.sum(t * dsum[k]) for t, k in own)).backward()
    grads = {n: w.grad.detach().clone() for n, w in layer.named_parameters()
             if w.grad is not None}
    for w in layer.parameters():
        w.grad = None
    return total, wide(xg.grad), grads, flops


def head_loss_by_hand(params, h, labels, cfg, tp, z_weight=1e-4):
    """The vocab-parallel cross-entropy of ``h [B, S, D]`` at ``labels``
    over ``tp`` shares of the head, each computed alone
    (``placement.model_split(part=(r, tp, None))``: its ``V / tp`` logit
    columns, no collective) and the three reductions over the shares done
    here by hand: the max of the shares' maxima (detached), the sum of
    their sums of ``exp(logit - max)``, the gold logit from the share that
    holds the label.  The mean nll plus ``z_weight`` times the mean lse²
    (``chunked_ce``'s loss with no mask), differentiable in ``h`` and the
    head's weight."""
    from repro_torch.dist import placement
    from repro_torch.models import lm

    n = cfg.vocab // tp
    logits = []
    for r in range(tp):
        with placement.model_split(part=(r, tp, None)):
            logits.append(lm.lm_head_share(params, h, cfg, lm.head_weight(params, cfg)))
    top = torch.stack([x.detach().amax(-1) for x in logits]).amax(0)
    lse = top + torch.log(sum(torch.exp(x - top[..., None]).sum(-1) for x in logits))
    gold = sum(torch.where((labels >= r * n) & (labels < (r + 1) * n),
                           torch.gather(x, -1, (labels - r * n).clamp(0, n - 1)[..., None])[..., 0],
                           0.0) for r, x in enumerate(logits))
    return (lse - gold).mean() + z_weight * torch.square(lse).mean()


def head_split_check(cfg, gen, tps):
    """Phase 16e's head: ``cfg``'s head at full width (its ``lm_head.w``,
    or the embedding's table where ``cfg.tie_embeddings``, drawn from
    ``gen``) on B = MESH_BATCH, S = MESH_SEQ hidden states and labels: for
    each tp, the shares' logits concatenated (``lm_head_apply`` under each
    part) against the whole head's; the loss combined by hand
    (:func:`head_loss_by_hand`) and its hidden-state and weight gradients
    against ``chunked_ce`` on the whole logits; each share's FLOPs
    (``lm_head_share``, forward and backward) against the whole's.
    Returns {tp: record}."""
    import contextlib
    import types

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import placement
    from repro_torch.models import lm
    from repro_torch.models.layers import dense_init
    from repro_torch.train.losses import chunked_ce

    dev = gen.device
    B, S, D, V = MESH_BATCH, MESH_SEQ, cfg.d_model, cfg.vocab
    shape = (V, D) if cfg.tie_embeddings else (D, V)
    w = dense_init(gen, shape, cfg.p_dtype).requires_grad_(True)
    params = (types.SimpleNamespace(embed={"table": w}, lm_head=None) if cfg.tie_embeddings
              else types.SimpleNamespace(embed={}, lm_head={"w": w}))
    h = torch.randn((B, S, D), generator=gen, device=dev).to(cfg.act_dtype)
    labels = torch.randint(0, V, (B, S), generator=gen, device=dev)

    def grads(loss_fn):
        w.grad = None
        hg = h.detach().clone().requires_grad_(True)
        loss = loss_fn(hg)
        loss.backward()
        return float(loss.detach()), hg.grad.float(), w.grad.float().clone()

    def flops(part):
        split = placement.model_split(part=part) if part else contextlib.nullcontext()
        w.grad = None
        with FlopCounterMode(display=False) as fc, split:
            lm.lm_head_share(params, h.detach().clone().requires_grad_(True), cfg).sum().backward()
        return fc.get_total_flops()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30)

    with torch.no_grad():
        whole = lm.lm_head_apply(params, h, cfg)
    want = grads(lambda x: chunked_ce(x, labels, lambda c: lm.lm_head_apply(params, c, cfg),
                                      cfg)[0])
    whole_flops = flops(None)
    out = {}
    for tp in tps:
        with torch.no_grad():
            shares = []
            for r in range(tp):
                with placement.model_split(part=(r, tp, None)):
                    shares.append(lm.lm_head_apply(params, h, cfg))
            cols = sorted({x.shape[-1] for x in shares})
            logits_rel = rel(torch.cat(shares, -1), whole)
            del shares
        got = grads(lambda x: head_loss_by_hand(params, x, labels, cfg, tp))
        share_flops = [flops((r, tp, None)) for r in range(tp)]
        out[tp] = {"columns": cols, "logits_rel": logits_rel, "loss": got[0],
                   "loss_whole": want[0], "loss_rel": abs(got[0] - want[0]) / abs(want[0]),
                   "dhidden_rel": rel(got[1], want[1]), "dweight_rel": rel(got[2], want[2]),
                   "flops_whole": whole_flops, "flops_shares": share_flops}
        torch.cuda.empty_cache()
    del whole, want
    return out


def recurrent_split_layers(cfgs, gen, B, S):
    """Phase 16e's rwkv6 and Mamba2 layers: for each config of ``cfgs``
    (an rwkv6 arch, a Mamba2 one) its first such layer drawn from ``gen``,
    as ``(name, layer, fn, x, whole_flops, what)``: ``fn`` the layer's ``x
    -> y`` (the time mix and the channel mix before their residuals; the
    Mamba2 layer after its pre-norm), ``x`` its input ``[B, S, d]`` from
    ``gen``, ``whole_flops(tp)`` the FLOPs (forward and backward) that
    every share computes whole (the time mix's token-shift and decay
    LoRAs, the channel mix's ``cm_r``, the B/C columns of the SSD's
    ``in_proj``), ``what(plan)`` how ``tp_plan`` splits it."""
    from repro_torch.models import lm
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.rwkv import LORA_R, MIX_R, rwkv6_channel_mix, rwkv6_time_mix
    from repro_torch.models.ssm import mamba2_apply

    def split(key, noun):
        return lambda plan: f"{'split' if plan[key] else 'whole'} {noun}"

    out = []
    for cfg in cfgs:
        D, dev = cfg.d_model, gen.device
        x = torch.randn((B, S, D), generator=gen, device=dev).to(cfg.act_dtype)
        gemm = 3 * 2 * B * S * D                 # a [B·S, D] x [D, 1] product, fwd + bwd
        if "rwkv6" in cfg.layer_types:
            m = lm.Block("rwkv6", cfg, gen).requires_grad_(True).rwkv
            out.append(("rwkv_time_mix", m, lambda h, m=m, c=cfg: rwkv6_time_mix(m, h, c)[0], x,
                        lambda tp, g=gemm: g * (10 * MIX_R + LORA_R),
                        split("rwkv_heads", "heads")))
            out.append(("rwkv_channel_mix", m,
                        lambda h, m=m, c=cfg: rwkv6_channel_mix(m, h, c)[0], x,
                        lambda tp, g=gemm, D=D: g * D, split("rwkv_cm_ffn", "d_ff columns")))
        else:
            block = lm.Block("mamba2", cfg, gen).requires_grad_(True)
            with torch.no_grad():
                h = norm_apply(block.ln1, x, cfg)
            gn = cfg.ssm.n_groups * cfg.ssm.state_dim
            out.append(("ssd", block.ssm, lambda h_, m=block.ssm, c=cfg: mamba2_apply(m, h_, c)[0],
                        h, lambda tp, g=gemm, gn=gn: g * 2 * gn, split("ssd_heads", "SSD heads")))
    return out


def phase_split(seed, card):
    """Phase 16e: MESH_ARCH's first block at full width, its attention and
    its GLU MLP, and the first rwkv6 block's time and channel mix and the
    first Mamba2 layer of MESH_RECURRENT_LAYERS' archs
    (:func:`recurrent_split_layers`, within MESH_RECURRENT_RTOL), computed
    as every share of "model" through
    ``placement.model_split(part=(r, tp, None))`` (the train step's split
    code, one share at a time, no collective) for each tp of
    MESH_SPLIT_TPS, in bf16 activations (the model's) and fp32: the sum of
    the shares' outputs, input gradients and parameter gradients against
    the whole layer's within MESH_SPLIT_RTOL, and each share's FLOPs
    (``FlopCounterMode``, forward and backward) beside the whole's: at most
    the whole's / tp plus the K/V projection where the KV heads stay whole
    (tp = 16: 4 KV heads).  Then its head (V = 32,000, d = 2,048; its own
    ``lm_head.w`` and tied to the embedding's table) as every share of the
    same tps (:func:`head_split_check`): the shares' logits concatenated,
    and the hidden-state and weight gradients of the loss combined by hand
    from the shares, within MESH_SPLIT_RTOL of the whole head's; that loss
    within MESH_HEAD_LOSS_RTOL (relative) of ``chunked_ce`` on the whole
    logits; each share ``V / tp`` columns wide and its FLOPs at most the
    whole head's / tp."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.models.layers import attn_apply, mlp_apply, norm_apply, tp_plan

    t0 = time.perf_counter()
    tag = "[mesh]"
    dev = torch.device("cuda")
    base = ARCHS[MESH_ARCH]
    gen = torch.Generator(dev).manual_seed(seed)
    B, S, D = MESH_BATCH, MESH_SEQ, base.d_model
    out = {"arch": base.name, "recurrent_archs": sorted(MESH_RECURRENT_LAYERS),
           "batch": [B, S], "card": card, "dtypes": {}}
    for dtype, rtol in MESH_SPLIT_RTOL.items():
        cfg = base.replace(dtype=dtype)
        block = lm.Block("attn", cfg, gen).requires_grad_(True)
        x = torch.randn((B, S, D), generator=gen, device=dev).to(cfg.act_dtype)
        kv_flops = 3 * 2 * 2 * B * S * D * cfg.n_kv_heads * cfg.head_dim
        layers_ = [
            ("attn", block.attn, lambda h: attn_apply(block.attn, h, cfg)[0],
             norm_apply(block.ln1, x, cfg), lambda tp: 0 if tp_plan(cfg, tp)["kv_heads"]
             else kv_flops,
             lambda plan: f"{'split' if plan['heads'] else 'whole'} query heads, "
                          f"{'split' if plan['kv_heads'] else 'whole'} KV heads"),
            ("mlp", block.mlp, lambda h: mlp_apply(block.mlp, h, cfg),
             norm_apply(block.ln2, x, cfg), lambda tp: 0,
             lambda plan: f"{'split' if plan['ffn'] else 'whole'} ffn columns")]
        layers_ += recurrent_split_layers(
            [ARCHS[a].replace(dtype=dtype) for a in MESH_RECURRENT_LAYERS], gen, B, S)
        rec = out["dtypes"][dtype] = {"rtol": rtol}
        for name, layer, fn, h, whole_part, what in layers_:
            lcfg = layer.cfg
            tol = rtol if name in ("attn", "mlp") else MESH_RECURRENT_RTOL[dtype]
            h = h.detach()
            dy = torch.randn(h.shape, generator=gen, device=dev).to(h.dtype)
            want_y, want_dx, want_g, (whole,) = split_shares(layer, fn, h, dy, [None])
            # the whole layer's own sensitivity: its input perturbed by
            # about one ulp of the activation dtype
            eps = torch.finfo(h.dtype).eps
            hp = (h.float() * (1 + eps * torch.randn(h.shape, generator=gen, device=dev))
                  ).to(h.dtype)
            p_y, p_dx, p_g, _ = split_shares(layer, fn, hp, dy, [None])
            floor = {k: float((a.float() - b.float()).abs().max())
                     / max(float(b.float().abs().max()), 1e-30)
                     for k, a, b in [("y", p_y, want_y), ("dx", p_dx, want_dx)]
                     + [(f"d{n}", p_g[n], want_g[n]) for n in want_g]}
            del hp, p_y, p_dx, p_g
            for tp in MESH_SPLIT_TPS:
                got_y, got_dx, got_g, flops = split_shares(
                    layer, fn, h, dy, [(r, tp, None) for r in range(tp)])
                pairs = [("y", got_y, want_y), ("dx", got_dx, want_dx)]
                pairs += [(f"d{n}", got_g[n], want_g[n]) for n in want_g]
                rels = {k: float((a.float() - b.float()).abs().max())
                        / max(float(b.float().abs().max()), 1e-30) for k, a, b in pairs}
                worst = max(rels, key=rels.get)
                plan = tp_plan(lcfg, tp)
                rec[f"{name}|tp{tp}"] = r = {
                    "arch": lcfg.name, "plan": plan, "rtol": tol, "max_rel": rels[worst],
                    "worst": worst,
                    "rels": rels, "floor": floor, "grads": sorted(got_g) == sorted(want_g),
                    "flops_whole": whole, "flops_shares": flops,
                    "flops_bound": whole / tp + whole_part(tp)}
                log(f"{tag} e. {lcfg.name} layer 0 {name}, {dtype} activations, B = {B}, "
                    f"S = {S}, tp = {tp} ({what(plan)}): the {tp} shares summed "
                    f"against the whole layer, largest |diff| / max {r['max_rel']:.3e} ({worst}; "
                    f"tolerance {tol:.0e}; the whole under a one-ulp input perturbation "
                    f"{floor[worst]:.3e}, at most {max(floor.values()):.3e}); FLOPs a share "
                    f"{min(flops):.4e}-{max(flops):.4e} against the whole's {whole:.4e} (ratio "
                    f"{max(flops) / whole:.4f}, 1/tp {1 / tp:.4f}, bound "
                    f"{r['flops_bound']:.4e}); {card}")
                check(r["max_rel"] <= tol and r["grads"],
                      f"{tag} e. {name} tp = {tp} {dtype}: the shares' sum differs from the "
                      f"whole ({worst} {r['max_rel']:.3e})")
                check(0 < max(flops) <= r["flops_bound"],
                      f"{tag} e. {name} tp = {tp}: a share's FLOPs {max(flops):.4e} pass "
                      f"{r['flops_bound']:.4e}")
            del want_y, want_dx, want_g, got_y, got_dx, got_g
        del block, x, layers_
        torch.cuda.empty_cache()
        for tied in (False, True):
            name = "head_tied" if tied else "head"
            recs = head_split_check(cfg.replace(tie_embeddings=tied), gen, MESH_SPLIT_TPS)
            for tp, r in recs.items():
                rec[f"{name}|tp{tp}"] = r
                worst = max(r["logits_rel"], r["dhidden_rel"], r["dweight_rel"])
                log(f"{tag} e. {cfg.name} head ({'tied to the embedding' if tied else 'lm_head.w'}"
                    f", V = {cfg.vocab}), {dtype} activations, B = {B}, S = {S}, tp = {tp}: "
                    f"{r['columns']} columns a share; the shares' logits against the whole "
                    f"head, largest |diff| / max {r['logits_rel']:.3e}, gradients of the loss "
                    f"combined by hand against chunked_ce's: hidden {r['dhidden_rel']:.3e}, "
                    f"weight {r['dweight_rel']:.3e} (tolerance {rtol:.0e}); loss "
                    f"{r['loss']:.8f} against {r['loss_whole']:.8f}, relative "
                    f"{r['loss_rel']:.3e} (tolerance {MESH_HEAD_LOSS_RTOL[dtype]:.0e}); FLOPs a "
                    f"share {min(r['flops_shares']):.4e}-{max(r['flops_shares']):.4e} against "
                    f"the whole's {r['flops_whole']:.4e} (ratio "
                    f"{max(r['flops_shares']) / r['flops_whole']:.4f}); {card}")
                check(r["columns"] == [cfg.vocab // tp],
                      f"{tag} e. {name} tp = {tp}: shares of {r['columns']} columns")
                check(worst <= rtol, f"{tag} e. {name} tp = {tp} {dtype}: the shares differ "
                                     f"from the whole head ({r})")
                check(r["loss_rel"] <= MESH_HEAD_LOSS_RTOL[dtype],
                      f"{tag} e. {name} tp = {tp} {dtype}: loss {r['loss']} against "
                      f"{r['loss_whole']}")
                check(0 < max(r["flops_shares"]) <= r["flops_whole"] / tp,
                      f"{tag} e. {name} tp = {tp}: a share's FLOPs {max(r['flops_shares'])} "
                      f"pass {r['flops_whole'] / tp}")
    out["seconds"] = time.perf_counter() - t0
    log(f"{tag} e. {out['seconds']:.1f} s")
    return out


def phase_mesh_train(seed, card, kernels, host_ms):
    """Phase 16: training on a (data, model) mesh, on one card.

    A one-rank NCCL group (a file store under build/) carries two
    DeviceMeshes, (1, 1) ("data", "model") and (1, 1, 1) ("pod", "data",
    "model"); every collective of the mesh path runs as a group of one.

    a. MESH_ARCH at full width and depth, fp32 params and AdamW moments,
       MESH_STEPS steps at B = MESH_BATCH, S = MESH_SEQ, under
       default_rules(fsdp=True) on the (1, 1) mesh: the state placed by
       launch.dryrun.param_shardings (place_state), each batch a DTensor
       (make_process_local_array, the launcher's make_global), the mesh
       train step; against the same seed's host steps in this process:
       losses within MESH_LOSS_RTOL at every step, the largest parameter
       difference after the steps; then one step of each of
       MESH_RECURRENT_LAYERS' archs at full width and that depth,
       bit for bit with the host path (:func:`mesh_steps`);
    b. MESH_MOE_ARCH at full width, B = MESH_MOE_BATCH, on the (1, 1, 1)
       mesh under default_rules(multi_pod=True, fsdp=True): one step's
       loss and gradients (as AdamW receives them) against the local
       path's (grads_of), every MoE layer through _moe_sharded;
    c. b's parameters checkpointed, restored with restore(shardings=)
       onto remesh([0]) (a (1, 1) ("data", "model") mesh) by its
       param_shardings: every leaf a DTensor there, equal bit for bit;
    d. one sharded search over ("pod", "data") of the (1, 1, 1) mesh
       ("model" replicated) at MESH_SEARCH: every answer equal to a brute
       force on the card;
    e. the "model" split of attention, the MLP, rwkv6's mixes and the
       Mamba2 layer, share by share (:func:`phase_split`).

    On the one-rank meshes of a-c "model" has one rank, so nothing splits.
    The training path (a-c, e) launches no kernel: the counts are zeroed
    before it and must read 0 after; d launches per call one pruned_topk
    and one block_bounds_select per shard.  ``host_ms`` is phase 14's ms a
    step, printed beside a's."""
    import functools
    import logging
    import shutil

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import elastic, placement
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.compat import make_process_local_array
    from repro_torch.launch.dryrun import param_shardings
    from repro_torch.models import model_fns, moe, synthetic_batch
    from repro_torch.optim import adamw, schedule
    from repro_torch.search import SearchEngine
    from repro_torch.train.train_step import init_state, make_train_step, place_state

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    tag = "[mesh]"
    dev = torch.device("cuda")
    store = ROOT / "build" / "mesh_store"
    ckpt = ROOT / "build" / "mesh_ckpt"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {"card": card}
    tally = LaunchTally(kernels)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        torch.cuda.set_device(0)
        mesh2 = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
        mesh3 = DeviceMesh("cuda", [[[0]]], mesh_dim_names=("pod", "data", "model"))

        # a. the dense arch, host steps then the same on the mesh
        cfg = ARCHS[MESH_ARCH]
        fns = model_fns(cfg)
        lr = functools.partial(schedule.warmup_cosine, peak_lr=TRAIN_LR,
                               warmup_steps=max(MESH_STEPS // 20, 5), total_steps=MESH_STEPS)
        data = SyntheticLM(cfg.vocab, MESH_SEQ, MESH_BATCH, seed=seed)
        host_batches = [data.batch(i) for i in range(MESH_STEPS)]
        torch.cuda.empty_cache()
        h_losses, h_ms, h_params = mesh_host_steps(fns, cfg, seed, host_batches, dev, lr)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tally.discard()
        m_losses, m_ms, m_params, placed = mesh_steps(fns, cfg, seed, host_batches, mesh2, lr)
        peak = gb(torch.cuda.max_memory_allocated())
        diff = max(float((m_params[n] - h_params[n]).abs().max()) for n in h_params)
        rel = max(abs(a - b) / abs(b) for a, b in zip(m_losses, h_losses))
        launches_a = tally.counts()
        del h_params, m_params
        torch.cuda.empty_cache()
        out["dense"] = {"arch": cfg.name, "batch": [MESH_BATCH, MESH_SEQ],
                        "losses_mesh": m_losses, "losses_host": h_losses,
                        "loss_max_rel": rel, "param_max_abs_diff": diff, "ms_mesh": m_ms,
                        "ms_host": h_ms, "ms_median_mesh": float(np.median(m_ms[1:])),
                        "ms_median_host": float(np.median(h_ms[1:])),
                        "phase14_ms_median": host_ms, "peak_gb": peak, "placements": placed,
                        "launches": launches_a}
        r = out["dense"]
        log(f"{tag} a. {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}) on a (1, 1) "
            f"(data, model) mesh, default_rules(fsdp=True), B = {MESH_BATCH}, S = "
            f"{MESH_SEQ}: {r['ms_median_mesh']:.1f} ms a step (median past the first; host "
            f"path in this phase {r['ms_median_host']:.1f}, phase 14 {host_ms:.1f}), peak "
            f"{peak:.2f} GB; losses mesh {[round(x, 6) for x in m_losses]}, host "
            f"{[round(x, 6) for x in h_losses]}, max rel diff {rel:.3e}; largest parameter "
            f"difference after {MESH_STEPS} steps {diff:.3e}; launches {launches_a}; {card}")
        for key, (n, loc, glob, pl) in placed.items():
            log(f"{tag} a. placement {key} (x{n}): local {loc} of global {glob}, {pl}")
        check(rel <= MESH_LOSS_RTOL, f"{tag} a. the mesh losses differ from the host path's")
        check(all(np.isfinite(m_losses)), f"{tag} a. a mesh loss is not finite")
        # a'. rwkv6 and zamba2 at full width, their depth cut: one step each
        out["recurrent"] = {}
        for arch, n_layers in MESH_RECURRENT_LAYERS.items():
            r_cfg = ARCHS[arch].replace(n_layers=n_layers)
            r_fns = model_fns(r_cfg)
            batch = [SyntheticLM(r_cfg.vocab, MESH_SEQ, MESH_BATCH, seed=seed + 2).batch(0)]
            h_loss, h_ms1, h_params = mesh_host_steps(r_fns, r_cfg, seed + 2, batch, dev, lr)
            torch.cuda.empty_cache()
            m_loss, m_ms1, m_params, _ = mesh_steps(r_fns, r_cfg, seed + 2, batch, mesh2, lr)
            unequal = [n for n in h_params if not torch.equal(m_params[n], h_params[n])]
            out["recurrent"][arch] = r = {
                "layers": list(r_cfg.layer_types), "batch": [MESH_BATCH, MESH_SEQ],
                "loss_host": h_loss[0], "loss_mesh": m_loss[0], "ms_host": h_ms1[0],
                "ms_mesh": m_ms1[0], "params": len(h_params), "params_unequal": unequal}
            log(f"{tag} a'. {arch} at full width (d {r_cfg.d_model}), {n_layers} layers "
                f"{r['layers']}, one step at B = {MESH_BATCH}, S = {MESH_SEQ} on the (1, 1) "
                f"mesh against the host path: loss {m_loss[0]!r} / {h_loss[0]!r}, parameters "
                f"not bit for bit {len(unequal)} of {len(h_params)}; {m_ms1[0]:.1f} / "
                f"{h_ms1[0]:.1f} ms; {card}")
            check(m_loss == h_loss and not unequal and all(np.isfinite(m_loss)),
                  f"{tag} a'. {arch}'s mesh step differs from the host path's: {unequal[:4]}")
            del h_params, m_params
            torch.cuda.empty_cache()

        # b. the MoE through _moe_sharded on the (1, 1, 1) mesh
        m_cfg = ARCHS[MESH_MOE_ARCH]
        m_fns = model_fns(m_cfg)
        batch = synthetic_batch(m_cfg, MESH_MOE_BATCH, MESH_MOE_SEQ, seed=seed + 1, device=dev)
        host = init_state(m_fns, seed + 1, device=dev)
        loss_h, g_h = grads_of(m_fns, m_cfg, host["params"], batch)
        g_h = {n: g.detach().cpu() for n, g in g_h.items()}
        del host
        torch.cuda.empty_cache()
        calls, captured = [], {}
        sharded, update = moe._moe_sharded, adamw.update

        def counted(*a, **kw):
            calls.append(1)
            return sharded(*a, **kw)

        def spy(grads, *a, **kw):
            captured.update({n: placement.local(g).detach().clone() for n, g in grads.items()})
            return update(grads, *a, **kw)

        shd.set_rules(mesh3, shd.default_rules(multi_pod=True, fsdp=True))
        moe._moe_sharded, adamw.update = counted, spy
        try:
            state = init_state(m_fns, seed + 1, device=dev)
            state = place_state(state, param_shardings(state["params"], mesh3, m_cfg))
            step = make_train_step(m_fns, m_cfg, lr_schedule=functools.partial(
                schedule.constant, peak_lr=TRAIN_LR))
            # the batch split over the data axes, as the launcher's make_global makes it
            batch_sh3 = shd.NamedSharding(mesh3, (("pod", "data"),))
            split_batch = {k: make_process_local_array(batch_sh3, x, x.shape)
                           for k, x in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, split_batch)
            torch.cuda.synchronize()
            moe_ms = (time.perf_counter() - t0) * 1e3
        finally:
            moe._moe_sharded, adamw.update = sharded, update
            shd.set_rules(None, None)
        g_rel = max(float((captured[n].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                    for n, g in g_h.items())
        del captured
        n_moe = sum(t == "moe" for t in m_cfg.layer_types)
        out["moe"] = {"arch": m_cfg.name, "batch": [MESH_MOE_BATCH, MESH_MOE_SEQ],
                      "loss_mesh": float(m["loss"]), "loss_local": float(loss_h),
                      "grad_max_rel": g_rel, "moe_sharded_calls": len(calls),
                      "moe_layers": n_moe, "step_ms": moe_ms}
        r = out["moe"]
        log(f"{tag} b. {m_cfg.name} ({m_cfg.n_layers} layers, d {m_cfg.d_model}) on a (1, 1, 1) "
            f"(pod, data, model) mesh, B = {MESH_MOE_BATCH}, S = {MESH_MOE_SEQ}: one step "
            f"{moe_ms:.0f} ms, loss {r['loss_mesh']:.6f} (local path {r['loss_local']:.6f}), "
            f"largest gradient difference over each leaf's max {g_rel:.3e}; _moe_sharded "
            f"calls {len(calls)} (forward and recompute of {n_moe} MoE layers); {card}")
        check(abs(r["loss_mesh"] - r["loss_local"]) <= MESH_LOSS_RTOL * abs(r["loss_local"]),
              f"{tag} b. the mesh MoE loss differs from the local path's")
        check(g_rel <= 1e-5, f"{tag} b. the mesh MoE gradients differ from the local path's")
        check(len(calls) >= n_moe, f"{tag} b. an MoE layer did not take _moe_sharded")

        # c. b's parameters checkpointed, restored onto remesh([0])
        cm = CheckpointManager(str(ckpt), async_save=False)
        want = {n: placement.local(p).detach().cpu() for n, p in state["params"].named_parameters()}
        t0 = time.perf_counter()
        cm.save(1, {"params": state["params"]})
        save_s = time.perf_counter() - t0
        del state, step
        torch.cuda.empty_cache()
        new_mesh = elastic.remesh([0], device_type="cuda")
        shd.set_rules(new_mesh, shd.default_rules(fsdp=True))
        try:
            target = init_state(m_fns, 0, abstract=True)["params"]
            sh = param_shardings(target, new_mesh, m_cfg)
            t0 = time.perf_counter()
            got, _, _ = cm.restore({"params": target}, 1, device=dev,
                                   shardings={"params": sh})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            shd.set_rules(None, None)
        bad = [n for n, p in got["params"].named_parameters()
               if not placement.is_dtensor(p) or p.device_mesh != new_mesh
               or not torch.equal(placement.local(p).detach().cpu(), want[n])]
        gbytes = gb(sum(t.numel() * t.element_size() for t in want.values()))
        out["restore"] = {"remesh": list(new_mesh.mesh.shape), "leaves": len(want),
                          "gb": gbytes, "save_s": save_s, "restore_s": restore_s,
                          "not_equal": bad}
        log(f"{tag} c. {gbytes:.2f} GB of {m_cfg.name} parameters saved in {save_s:.1f} s, "
            f"restored onto remesh([0]) = {list(new_mesh.mesh.shape)} (data, model) in "
            f"{restore_s:.1f} s; leaves not placed or not equal: {len(bad)} of {len(want)}")
        check(not bad, f"{tag} c. a restored leaf is not on the new mesh or differs: {bad[:4]}")
        del got, want, target
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()

        # e. attention and the MLP per share of "model", one share at a time
        out["split"] = phase_split(seed + 5, card)
        launches_train = tally.counts()
        check(all(v == 0 for v in launches_train.values()),
              f"{tag} the training path launched a kernel: {launches_train}")

        # d. a sharded search over ("pod", "data") of the (1, 1, 1) mesh
        spec = MESH_SEARCH
        rng = np.random.default_rng(seed + 16)
        c = mixture_centres(dict(spec, key="mesh"), seed + 16)
        db = mixture_draw(rng, c, spec["n"], spec["noise"])
        q = mixture_draw(rng, c, spec["m"], spec["noise"])
        eng = SearchEngine.build(db, mesh=mesh3, axis_names=("pod", "data"),
                                 n_shards=spec["shards"], n_pivots=16, block_size=128,
                                 tree_shards=False)
        tally.discard()
        s, i, _ = eng.search(q, spec["k"])
        launches_d = tally.counts()
        dbn = torch.nn.functional.normalize(torch.as_tensor(db, device=dev), dim=1)
        qn = torch.nn.functional.normalize(torch.as_tensor(q, device=dev), dim=1)
        s_b, i_b = brute_topk(qn, dbn, spec["k"])
        err = float((s.to(dev) - s_b).abs().max())
        bad_rows = tie_aware_mismatches(s.cpu().numpy(), i.cpu().numpy(), s_b.cpu().numpy(),
                                        i_b.cpu().numpy(), 1e-5)
        out["search"] = {"spec": spec, "backend": eng.backend_name, "max_abs_err": err,
                         "rows_differing": bad_rows, "launches": launches_d}
        log(f"{tag} d. sharded search over (pod, data) of the (1, 1, 1) mesh, {spec['shards']} "
            f"shards of {spec['n'] // spec['shards']:,} rows, {spec['m']} queries, k = "
            f"{spec['k']}: backend {eng.backend_name}, max |sim - brute| {err:.2e}, rows "
            f"differing beyond near-ties {bad_rows}; launches {launches_d}")
        check(eng.backend_name == "sharded" and err <= 1e-5 and bad_rows == 0,
              f"{tag} d. the search over (pod, data) differs from the brute force")
        del eng, db, q, dbn, qn
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = {"mesh_train": launches_train, "mesh_search": launches_d}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"{tag} phase 16 on {card}: {out['seconds']:.1f} s; launches {out['launches']}; "
        f"collectives of more than one card do not run here")
    return out


def phase_bf16_db(eng, qn, qp, brute, kernel_inputs, pruned_topk, pruned_topk_plain):
    """Phase 17a: pruned_topk over a bf16 db, at phase 3's operands.

    Phase 3's clustered-64 index with its db cast to bf16 (the
    reference's ``dot_general`` of fp32 queries with bf16 rows), its
    10,000 queries at k = 10 and 100, the engine's operands and splits
    (kernel_inputs).  The drive: one launch per k with row_out (the
    queries' own order), the launch count set to 0 before it, held to
    phase 3's fp32 brute force within BF16_DB_ATOL.  Then the kernel
    against its plain version on the same bf16 rows (check_topk, phase
    5a's contract), and the kernel's ms beside the fp32 kernel's at the
    same operands and splits, in turns.  Returns (report, kernels entry)."""
    t_phase = time.perf_counter()
    out, db16, launches = {}, None, 0
    for k in (10, 100):
        a, kw, perm = kernel_inputs(
            eng.index, qn, qp, k, bm=eng.bm, bn=eng.bn, warm_start=eng.warm_start,
            best_first=eng.best_first, margin=eng.margin,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
        if db16 is None:
            db16 = a[1].to(torch.bfloat16)
        a16 = (a[0], db16, *a[2:])
        pruned_topk.launches = 0
        sims = pruned_topk(*a16, **dict(kw, row_out=perm))[0]
        torch.cuda.synchronize()
        launches += pruned_topk.launches
        check(pruned_topk.launches == 1, f"the bf16 drive at k={k} launched "
                                         f"{pruned_topk.launches} times")
        vs_brute = float(np.abs(sims.cpu().numpy() - brute[k][0]).max())
        del sims
        got = pruned_topk(*a16, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pruned_topk_plain(*a16, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        r = check_topk(got, want, a16, kw, 1e-5, pruned_topk_plain)
        computed16 = got[2]
        del got, want
        fp32 = pruned_topk(*a, **kw)[2]
        ms16, ms32 = [], []
        for _ in range(REPS):
            ms16 += cuda_ms(lambda: pruned_topk(*a16, **kw), 1)
            ms32 += cuda_ms(lambda: pruned_topk(*a, **kw), 1)
        valid = eng.index.valid

        def library():
            dbf = db16.float()
            for s in range(0, a[0].shape[0], 2000):
                torch.topk((a[0][s:s + 2000] @ dbf.T).masked_fill_(~valid[None, :],
                                                                     float("-inf")), k, dim=1)
        lib = cuda_ms(library, REPS)
        nbytes, ops = pruned_topk_costs(a16, kw, computed16)
        run = {"check": r, "max_abs_err_vs_fp32_brute": vs_brute, "plain_ms": plain_ms,
               "ms": float(np.median(ms16)), "fp32_ms": float(np.median(ms32)),
               "ms_all": ms16, "fp32_ms_all": ms32, "splits": kw["splits"],
               "tile_computed_frac": float(computed16.float().mean()),
               "fp32_tile_computed_frac": float(fp32.float().mean()),
               "library_ms": float(np.median(lib)), **bound_entry(nbytes, ops)}
        out[f"k{k}"] = run
        log(f"[bf16 db] pruned_topk k={k}, splits={kw['splits']}: against its plain "
            f"version {r}; against the fp32 brute force max |diff| {vs_brute:.3e} "
            f"(<= {BF16_DB_ATOL}); bf16 {run['ms']:.3f} ms, fp32 {run['fp32_ms']:.3f} ms "
            f"(in turns), tile_computed_frac {run['tile_computed_frac']:.4f} (fp32 "
            f"{run['fp32_tile_computed_frac']:.4f}), plain {plain_ms:.1f} ms, bound "
            f"{run['bound_ms']:.3f} ms ({run['bound_by']}), matmul+topk "
            f"{run['library_ms']:.3f} ms")
        check(topk_ok(r, 1e-5), f"pruned_topk over the bf16 db at k={k} disagrees with "
                                f"its plain version: {r}")
        check(vs_brute <= BF16_DB_ATOL, f"pruned_topk over the bf16 db at k={k} is "
                                        f"{vs_brute} from the fp32 brute force")
        del a, a16, kw, perm, computed16, fp32
    out["seconds"] = time.perf_counter() - t_phase
    k10 = out["k10"]
    entry = {
        "name": "pruned_topk_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pruned_topk.cu",
        "replaces": "src/repro/kernels/cosine_topk.py:165",
        "launches": launches,
        "max_abs_err": max(out[f"k{k}"]["check"]["max_abs_err"] for k in (10, 100)),
        "ms": k10["ms"], "plain_ms": k10["plain_ms"], "bound_ms": k10["bound_ms"],
        "bound_by": k10["bound_by"], "library_ms": k10["library_ms"],
        "library": "db.float() + torch.matmul + torch.topk over the same queries and "
                   "rows, 5 calls of 2,000 queries",
        "fp32_ms": k10["fp32_ms"], "splits": k10["splits"],
        "tile_computed_frac": k10["tile_computed_frac"],
        "fp32_tile_computed_frac": k10["fp32_tile_computed_frac"],
        "max_abs_err_vs_fp32_brute": max(out[f"k{k}"]["max_abs_err_vs_fp32_brute"]
                                         for k in (10, 100)),
        "k100": {key: out["k100"][key] for key in (
            "ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tile_computed_frac", "fp32_tile_computed_frac")},
        "launches_by_path": {"bf16_db": launches}}
    log(f"[bf16 db] phase 17a: {out['seconds']:.1f} s")
    return out, entry


def lower_card_cells(path):
    """The fake half of phase 17b, in a process of its own: lower_cell of
    DRYRUN_CARD_CELLS on a (1, 1) CUDA mesh at rank 0 of a fake world of
    one rank, the records to ``path`` (JSON)."""
    import logging

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.dryrun import lower_cell

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        torch.cuda.set_device(0)
        mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
        recs = {shape: lower_cell(DRYRUN_ARCH, shape, mesh, scale=scale)
                for shape, scale in DRYRUN_CARD_CELLS}
    finally:
        dist.destroy_process_group()
    Path(path).write_text(json.dumps(recs))


def start_dryruns():
    """Phase 17's fake-tensor runs, started with the script in processes of
    their own at a low priority: they take minutes of host CPU (one
    tensor op of the step at a time, every layer, under FakeTensorMode)
    and no card time.  One process lowers DRYRUN_CARD_CELLS
    (:func:`lower_card_cells`), one per cell of DRYRUN_POD_CELLS runs
    ``python -m repro_torch.launch.dryrun --mesh both`` into
    build/dryrun_torch/cells.  Returns [(name, process, log path)]."""
    out = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    cmds = [("card_cells", [sys.executable, str(Path(__file__).resolve()), "--lower-cells",
                            str(out / "card_cells.json")])]
    for arch, shape in DRYRUN_POD_CELLS:
        cmds.append((f"{arch}__{shape}", [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
            shape, "--mesh", "both", "--out", str(out / "cells")]))
    procs = []
    for name, cmd in cmds:
        logf = out / f"{name}.log"
        with open(logf, "w") as f:
            procs.append((name, subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=f,
                                                 stderr=subprocess.STDOUT,
                                                 preexec_fn=lambda: os.nice(10)), logf))
    return procs


def stop_dryruns(procs):
    """Ends every process :func:`start_dryruns` started that still runs."""
    for _, p, _ in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def wait_dryruns(procs):
    """Waits for the dry-run's processes (DRYRUN_WAIT_S in all); any that
    failed or did not end fails the run, with its log's tail."""
    t_end = time.perf_counter() + DRYRUN_WAIT_S
    for name, p, logf in procs:
        try:
            p.wait(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
        if p.returncode is None:
            stop_dryruns(procs)
            check(False, f"the dry-run's {name} did not end in {DRYRUN_WAIT_S} s: "
                         f"{logf.read_text()[-2000:]}")
        check(p.returncode == 0, f"the dry-run's {name} exited {p.returncode}: "
                                 f"{logf.read_text()[-3000:]}")


def placed_bytes(cell):
    """The bytes of ``cell``'s real placed state: each parameter's local
    storage (the DTensors' parts), the moments, the batch, the cache's
    local shards."""
    from repro_torch.dist import placement

    def nbytes(t):
        return t.numel() * t.element_size()
    total = sum(nbytes(placement.local(p)) for p in cell.model.parameters())
    args = cell.args
    total += sum(nbytes(t) for t in args.get("moments", {}).values())
    total += sum(nbytes(t) for t in args["batch"].values())
    total += sum(nbytes(t) for t in args.get("cache", {}).values())
    return total


def long_train_step(seed, card):
    """Phase 17b's long step: DRYRUN_ARCH at full width and depth, fp32
    params and moments (init_state, make_train_step: the host path), one
    step at B = 1, S = LONG_SEQ; its loss against a no_grad forward's of
    the same weights and batch.  Returns the record."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model_fns
    from repro_torch.train.train_step import init_state, make_loss_fn, make_train_step

    cfg = ARCHS[DRYRUN_ARCH]
    fns = model_fns(cfg)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in SyntheticLM(cfg.vocab, LONG_SEQ, 1, seed=seed).batch(0).items()}
    torch.cuda.empty_cache()
    state = init_state(fns, seed, device="cuda")
    with torch.no_grad():
        want = float(make_loss_fn(fns, cfg)(state["params"], batch)[0])
    step = make_train_step(fns, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    loss = float(m["loss"])
    del state, step, m
    torch.cuda.empty_cache()
    tiles = cfg.n_heads * LONG_SEQ ** 2 * 4
    run = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": [1, LONG_SEQ],
           "remat": cfg.remat, "ms": ms, "peak_gib": peak / 2**30, "loss": loss,
           "no_grad_loss": want, "loss_rel_diff": abs(loss - want) / abs(want),
           "score_tiles_a_layer_gib": tiles / 2**30}
    log(f"[dryrun] b. one train step of {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"remat {cfg.remat}, fp32 params and moments) at B = 1, S = {LONG_SEQ:,}: "
        f"{ms:.1f} ms, peak {run['peak_gib']:.3f} GiB (one layer's score tiles "
        f"{run['score_tiles_a_layer_gib']:.1f} GiB in fp32); loss {loss:.7f}, no_grad "
        f"forward {want:.7f}, rel diff {run['loss_rel_diff']:.3e}; {card}")
    check(bool(np.isfinite(loss)), f"the S = {LONG_SEQ} step's loss is {loss}")
    check(run["loss_rel_diff"] <= LONG_LOSS_RTOL,
          f"the S = {LONG_SEQ} step's loss {loss} differs from the no_grad forward's {want}")
    return run


def phase_dryrun(seed, card, procs, kernels):
    """Phases 17b and 17c: the dry-run against the card, and production
    cells on fake worlds.

    b. For each of DRYRUN_CARD_CELLS (DRYRUN_ARCH at full width and
       depth, random weights from the seed): the fake run's record (the
       process start_dryruns began, lower_cell on a (1, 1) CUDA mesh), then
       the same cell built for real on a one-rank NCCL (1, 1) DeviceMesh
       (build_cell) and its step run once on the card.  argument_bytes
       equals the bytes of the real placed state, exactly; argument_bytes
       + temp_bytes lies within DRYRUN_MEM_RTOL of the step's peak
       (torch.cuda.max_memory_allocated after reset_peak_memory_stats,
       less what was allocated before the step besides its arguments);
       the decode step (its cache filled from the seed) gives logits equal
       bit for bit to the host path's decode_step and lm_head on the same
       weights, cache and tokens, and leaves the same cache.  Then
       :func:`long_train_step`, S = LONG_SEQ.
    c. Every cell of DRYRUN_POD_CELLS on the pod and the multipod mesh
       (run_cell at rank 0 of a fake world of 256 and 512 ranks, fake
       tensors on the card's device type) is OK; their memory per rank,
       FLOPs and collective bytes by kind are printed.

    The dry-run path launches no kernel: the counts of ``kernels`` are set
    to 0 before b and must read 0 after it."""
    import logging

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import model_fns

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    out = {"card": card}
    t0 = time.perf_counter()
    wait_dryruns(procs)
    out["waited_s"] = time.perf_counter() - t0
    base = ROOT / "build" / "dryrun_torch"
    fake = json.loads((base / "card_cells.json").read_text())
    dev = torch.device("cuda")
    store = ROOT / "build" / "dryrun_store"
    store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    tally = LaunchTally(kernels)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        torch.cuda.set_device(0)
        mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
        for shape, scale in DRYRUN_CARD_CELLS:
            rec = fake[shape]
            gen = torch.Generator(dev).manual_seed(seed)
            with dryrun.cell_rules(shape, mesh):
                cell = dryrun.build_cell(DRYRUN_ARCH, shape, mesh, scale=scale, seed=seed)
                real = placed_bytes(cell)
                host = None
                if cell.cache is not None:
                    with torch.no_grad():
                        for t in cell.args["cache"].values():
                            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
                        tok = cell.args["batch"]["tokens"]
                        tok.copy_(torch.randint(0, cell.cfg.vocab, tok.shape, generator=gen,
                                                device=dev, dtype=tok.dtype))
                    host = ({p: t.cpu() for p, t in cell.args["cache"].items()}, tok.clone())
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                res = cell.step()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                measured = peak - (before - real)
                predicted = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
                run = {"argument_bytes": rec["memory"]["argument_bytes"], "placed_bytes": real,
                       "temp_bytes": rec["memory"]["temp_bytes"], "predicted_peak": predicted,
                       "measured_peak": measured, "max_memory_allocated": peak,
                       "allocated_before": before,
                       "rel_diff": (predicted - measured) / measured,
                       "flops": rec["cost"]["flops"], "collectives": rec["collectives"],
                       "lower_s": rec["lower_s"]}
                if cell.cache is None:
                    run["loss"] = float(res[2])
                    check(bool(np.isfinite(run["loss"])), f"the {shape} step's loss is "
                                                          f"{run['loss']}")
                else:
                    logits, new = res
                    mesh_logits = logits.clone()
                    mesh_cache = {p: t.cpu() for p, t in dryrun.cache_leaves(new).items()}
                    del res, logits, new
            if cell.cache is not None:
                cfg = cell.cfg
                del cell
                torch.cuda.empty_cache()
                fns = model_fns(cfg)
                params = fns.init(seed, device=dev)
                cache_h, tok_h = host
                with torch.no_grad():
                    hcache = lm_mod.lm_cache_init(cfg, tok_h.shape[0], SHAPES[shape].seq,
                                                  device=dev)
                    for p, t in dryrun.cache_leaves(hcache).items():
                        t.copy_(cache_h[p].to(dev))
                    hidden, hnew = fns.decode_step(params, tok_h, hcache, SHAPES[shape].seq - 1)
                    host_logits = fns.lm_head(params, hidden)
                hflat = {p: t.cpu() for p, t in dryrun.cache_leaves(hnew).items()}
                run["logits_equal"] = torch.equal(mesh_logits, host_logits)
                run["cache_equal"] = all(torch.equal(mesh_cache[p], hflat[p]) for p in hflat)
                run["max_abs_logit_diff"] = float((mesh_logits - host_logits).abs().max())
                del params, hcache, hnew, host_logits, mesh_logits
            else:
                del cell, res
            torch.cuda.empty_cache()
            out[shape] = run
            log(f"[dryrun] {DRYRUN_ARCH} x {shape} at scale {scale} on a (1, 1) mesh: "
                f"argument_bytes {run['argument_bytes']:,} (placed on the card "
                f"{real:,}); argument + temp {predicted / 2**30:.3f} GiB predicted, "
                f"{measured / 2**30:.3f} GiB measured (max_memory_allocated "
                f"{peak / 2**30:.3f} GiB, {before / 2**30:.3f} GiB allocated before), "
                f"{100 * run['rel_diff']:+.1f} %"
                + (f"; mesh decode logits equal to the host path's {run['logits_equal']}, "
                   f"cache equal {run['cache_equal']}" if "logits_equal" in run else "")
                + f"; fake step {run['lower_s']} s, {card}")
            check(run["argument_bytes"] == real, f"{shape}: argument_bytes "
                                                 f"{run['argument_bytes']} != placed {real}")
            check(abs(run["rel_diff"]) <= DRYRUN_MEM_RTOL,
                  f"{shape}: predicted peak {predicted} vs measured {measured}")
            if "logits_equal" in run:
                check(run["logits_equal"] and run["cache_equal"],
                      f"{shape}: the mesh decode differs from the host path: {run}")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    out["long_step"] = long_train_step(seed, card)
    out["launches"] = tally.counts()
    check(not any(out["launches"].values()), f"the dry-run path launched kernels: "
                                             f"{out['launches']}")

    # c. the production cells' records
    cells = {}
    for arch, shape in DRYRUN_POD_CELLS:
        for mesh_kind in ("pod", "multipod"):
            rec = json.loads((base / "cells" / mesh_kind / f"{arch}__{shape}.json").read_text())
            check("error" not in rec and "memory" in rec,
                  f"the dry-run's {arch} x {shape} [{mesh_kind}] failed: "
                  f"{rec.get('error')} {rec.get('traceback', '')[-1500:]}")
            mem = rec["memory"]
            cells[f"{arch}__{shape}__{mesh_kind}"] = {
                "mem_per_rank_gib": (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30,
                **mem, "flops": rec["cost"]["flops"],
                "bytes_accessed": rec["cost"]["bytes accessed"],
                "collectives": rec["collectives"], "lower_s": rec["lower_s"]}
            coll = ", ".join(f"{kind} {v['count']} x {v['bytes'] / 2**20:.0f} MiB"
                             for kind, v in sorted(rec["collectives"].items()))
            log(f"[dryrun] OK {arch} x {shape} [{mesh_kind}]: memory per rank "
                f"{(mem['argument_bytes'] + mem['temp_bytes']) / 2**30:.2f} GiB (arguments "
                f"{mem['argument_bytes'] / 2**30:.2f}), {rec['cost']['flops']:.4e} FLOPs, "
                f"collectives: {coll}; fake step {rec['lower_s']} s")
    out["cells"] = cells
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phases 17b-c: {out['seconds']:.1f} s ({out['waited_s']:.1f} s of it "
        f"waiting for the fake runs)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the full report is written (JSON)")
    ap.add_argument("--lower-cells", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.lower_cells:
        lower_card_cells(args.lower_cells)
        return 0
    procs = start_dryruns()
    try:
        return run_phases(args, procs)
    finally:
        stop_dryruns(procs)


def run_phases(args, procs) -> int:
    """Phases 1-17 (see the module's docstring); ``procs``: the dry-run's
    processes (:func:`start_dryruns`)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.bound_prune import (block_bounds,
                                                 block_bounds_plain, block_bounds_select,
                                                 block_bounds_select_plain,
                                                 sqrt_mismatches)
    from repro_torch.kernels.cosine_topk import (_launch, _operands, merge_splits,
                                                 merge_splits_plain, pruned_topk,
                                                 pruned_topk_plain, scatter_rows)
    from repro_torch.search import SearchEngine
    from repro_torch.search.backends import (SELECT_ROUTE_MAX_N_PRE, kernel_inputs,
                                             prep_queries, prescan_blocks)

    report = {}
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(  # repro-lint: disable=R003 -- nvidia-smi, not python
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
    torch.backends.cudnn.allow_tf32 = False
    report["device"] = {"nvidia_smi": card, "torch": torch.__version__}

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.2f} s for {sorted(built) or 'cached'}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # the main path's kernels; past SELECT_ROUTE_MAX_N_PRE prescanned tiles the
    # engine takes block_bounds and a sort in place of block_bounds_select.
    # merge_splits is pruned_topk's epilogue: its own kernel never launches
    kernels = (pruned_topk, block_bounds_select)
    absent = (merge_splits,)
    wide_path = (SELECT_ROUTE_MAX_N_PRE + 1, (pruned_topk, block_bounds))

    # 3. the main path at full width, and its wide-prescan path
    eng, q, report["clustered64"], brute64 = phase_search(
        CLUSTERED64, args.seed, SearchEngine, kernels, wide=wide_path, absent=absent)
    launches = dict(report["clustered64"]["launches"],
                    block_bounds=report["clustered64"]["wide_prescan_k10"]["launches"][
                        "block_bounds"])

    # 5a. pruned_topk at the main path's operands (k = 10): at one split and
    # at the engine's chosen splits, each against the plain version at the
    # same splits, timed in turns
    qn, qp = prep_queries(eng.index, q)
    kargs, kkw, _ = kernel_inputs(
        eng.index, qn, qp, 10, bm=eng.bm, bn=eng.bn, warm_start=eng.warm_start,
        best_first=eng.best_first, margin=eng.margin,
        warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
    chosen = kkw["splits"]
    check(chosen > 1, f"the engine chose {chosen} splits at the main path")
    report["profile"] = profile_search(eng, q, 10, kargs[2].shape[0] * kargs[3].shape[0])
    kw_of = {s: dict(kkw, splits=s) for s in (1, chosen)}
    runs = {}
    for s, kw_s in kw_of.items():
        got = pruned_topk(*kargs, **kw_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pruned_topk_plain(*kargs, **kw_s)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        r = check_topk(got, want, kargs, kw_s, 1e-5, pruned_topk_plain)
        runs[s] = dict(r=r, plain_ms=plain_ms, computed=got[2], ms=[],
                       frac=float(got[2].float().mean()))
        log(f"[kernels] pruned_topk at main-path operands, splits={s}: {r}, "
            f"plain {plain_ms:.1f} ms, tile_computed_frac {runs[s]['frac']:.4f}")
        check(topk_ok(r, 1e-5),
              f"pruned_topk at splits={s} disagrees with its plain version: {r}")
        del got, want
    for _ in range(REPS):
        for s, kw_s in kw_of.items():
            runs[s]["ms"] += cuda_ms(lambda: pruned_topk(*kargs, **kw_s), 1)
    one, best = runs[1], runs[chosen]
    check(bool((best["computed"] >= one["computed"]).all()),
          "the splits skipped a tile that the single pass computes")
    # score flops from the single pass's computed tiles: the extra tiles
    # that splits compute count against the kernel
    nbytes, ops = pruned_topk_costs(kargs, kkw, one["computed"])
    lib = []
    for s in range(0, kargs[0].shape[0], 2000):
        qc = kargs[0][s:s + 2000]
        lib += cuda_ms(lambda: torch.topk(
            (qc @ kargs[1].T).masked_fill_(~eng.index.valid[None, :], float("-inf")),
            10, dim=1), 1)
    ms_one, ms_best = (float(np.median(runs[s]["ms"])) for s in (1, chosen))
    topk_entry = {
        "name": "pruned_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pruned_topk.cu",
        "replaces": "src/repro/kernels/cosine_topk.py:165",
        "launches": launches["pruned_topk"],
        "max_abs_err": max(one["r"]["max_abs_err"], best["r"]["max_abs_err"]),
        "ms": ms_best, "plain_ms": best["plain_ms"], **bound_entry(nbytes, ops),
        "library_ms": float(sum(lib)),
        "splits": chosen, "ms_splits1": ms_one, "plain_ms_splits1": one["plain_ms"],
        "tile_computed_frac": best["frac"], "tile_computed_frac_splits1": one["frac"],
        "ms_all": runs[chosen]["ms"], "ms_splits1_all": runs[1]["ms"],
        "ids_equal": best["r"]["ids_equal"] and one["r"]["ids_equal"],
        "computed_flips": best["r"]["computed_flips"] + one["r"]["computed_flips"],
        "flips_unexplained": (best["r"]["flips_unexplained"]
                              + one["r"]["flips_unexplained"]),
        "library": "torch.matmul + torch.topk over the same queries and rows, "
                   "5 calls of 2,000 queries"}
    topk_entry["bound_share"] = topk_entry["bound_ms"] / ms_best
    log(f"[kernels] pruned_topk: splits={chosen} {ms_best:.3f} ms, splits=1 "
        f"{ms_one:.3f} ms, bound {topk_entry['bound_ms']:.3f} ms "
        f"({topk_entry['bound_by']}, {topk_entry['bound_share']:.3f} of it at "
        f"splits={chosen}), matmul+topk {topk_entry['library_ms']:.3f} ms")

    # 5a'. the merge, pruned_topk's epilogue, at the main path's operands at
    # k = 10 and 100, at the chosen splits and at 1, with row_out = the
    # engine's query sort: against merge_splits_plain of the same launch's
    # partial lists, scattered by row_out, bit for bit, and against the old
    # route; the routes' times (merge_routes)
    merge_runs = {}
    for k in (10, 100):
        a_k, kw_k, perm = kernel_inputs(
            eng.index, qn, qp, k, bm=eng.bm, bn=eng.bn, warm_start=eng.warm_start,
            best_first=eng.best_first, margin=eng.margin,
            warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
        for s in (chosen, 1):
            ops_m, kw_m = _operands(*a_k, **dict(kw_k, splits=s, row_out=perm))
            out = _launch(*ops_m, **kw_m)
            sims, idx = out.sims, out.idx
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = [scatter_rows(x, perm) for x in merge_splits_plain(out.part_s, out.part_i)]
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            del out
            old, times = merge_routes(_launch, merge_splits, ops_m, kw_m, perm)
            fin = torch.isfinite(want[0])
            run = {"equal": torch.equal(sims, want[0]) and torch.equal(idx, want[1]),
                   "old_route_equal": torch.equal(old[0], sims) and torch.equal(old[1], idx),
                   "minus_one": bool((idx[~fin] == -1).all()),
                   "max_abs_err": float((sims[fin] - want[0][fin]).abs().max())
                   if bool(fin.any()) else 0.0, "plain_ms": plain_ms, **times}
            check(run["equal"] and run["old_route_equal"] and run["minus_one"],
                  f"pruned_topk's merge at k={k}, splits={s} differs: {run}")
            del sims, idx, want, old
            # each partial entry read once, the result written once, row_out
            # read once; at least ceil(log2 S) comparisons per output slot
            m_ = ops_m[0].shape[0]
            run.update(bound_entry(8 * (s + 1) * m_ * k + 4 * m_,
                                   float(m_) * k * int(np.ceil(np.log2(s)))))
            if s > 1:
                part = _launch(*ops_m, **dict(kw_m, row_out=None, fused=False)).part_s
                flat = part.transpose(0, 1).reshape(m_, s * k).contiguous()
                run["library_ms"] = float(np.median(
                    cuda_ms(lambda: torch.topk(flat, k, dim=1), REPS)))
                del part, flat
            merge_runs[(k, s)] = run
            log(f"[kernels] pruned_topk merge k={k} splits={s}: equal to plain and to "
                f"the old route {run['equal'] and run['old_route_equal']}; in turns: "
                f"fused {run['fused_ms']:.3f} ms, unfused {run['unfused_ms']:.3f} ms, "
                f"unfused + merge_splits + gathers {run['old_route_ms']:.3f} ms (paired "
                f"differences {run['fused_minus_unfused_ms']:.4f} and "
                f"{run['old_route_minus_unfused_ms']:.4f} ms); the epilogue's merge per "
                f"query tile {run['epilogue_us_median']:.1f} us (slowest tile "
                f"{run['epilogue_us_max']:.1f} us), its tail past the last arrival "
                f"{run['epilogue_tail_us']:.1f} us; the old merge + argsort + gathers "
                f"alone {run['old_merge_alone_ms']:.4f} ms; plain {plain_ms:.1f} ms, "
                f"bound {run['bound_ms']:.4f} ms, torch.topk "
                f"{run.get('library_ms', float('nan')):.3f} ms")
            del ops_m, kw_m
        del a_k, kw_k, perm
    report["merge"] = {f"k{k}_splits{s}": r for (k, s), r in merge_runs.items()}

    # 17a. pruned_topk over a bf16 db at the main path's operands, while
    # phase 3's index and brute force are held
    held = pruned_topk.launches
    report["bf16_db"], bf16_entry = phase_bf16_db(eng, qn, qp, brute64, kernel_inputs,
                                                  pruned_topk, pruned_topk_plain)
    pruned_topk.launches = held
    m10, m100 = merge_runs[(10, chosen)], merge_runs[(100, chosen)]
    merge_entry = {
        "name": "merge_splits", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pruned_topk.cu",
        "replaces": "src/repro/kernels/cosine_topk.py:165",
        "fused": "pruned_topk_kernel's epilogue: the last split CTA of each query "
                 "tile merges its lists and writes them in the caller's order",
        # the epilogue runs in every pruned_topk launch; merge_splits_kernel
        # itself never launches on the main path
        "launches": launches["pruned_topk"],
        "merge_splits_kernel_launches": launches["merge_splits"],
        "max_abs_err": max(r["max_abs_err"] for r in merge_runs.values()),
        "ms": m10["fused_minus_unfused_ms"], "plain_ms": m10["plain_ms"],
        "bound_ms": m10["bound_ms"], "bound_by": m10["bound_by"],
        "library_ms": m10["library_ms"],
        "library": "torch.topk over each row's splits x k entries, laid out "
                   "[M, S*k] beforehand",
        "ms_is": "paired median of (fused kernel - kernel without its epilogue), "
                 "k = 10, chosen splits",
        "replaced_route": "merge_splits_kernel + argsort(perm) + two gathers by inv",
        "replaced_route_ms": m10["old_route_minus_unfused_ms"],
        "replaced_route_alone_ms": m10["old_merge_alone_ms"],
        "epilogue_us_median": m10["epilogue_us_median"],
        "epilogue_us_max": m10["epilogue_us_max"],
        "epilogue_tail_us": m10["epilogue_tail_us"],
        "k100": {key: m100[key] for key in (
            "fused_minus_unfused_ms", "old_route_minus_unfused_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "fused_ms", "unfused_ms",
            "old_route_ms", "old_merge_alone_ms", "epilogue_us_median",
            "epilogue_us_max", "epilogue_tail_us")},
        "splits": chosen}
    topk_entry["ms_fused_k100"] = m100["fused_ms"]
    del runs, one, best

    # 5b. block_bounds in both modes at the main path's [10,000 x 9,247 x 16]
    lo, hi, qps, cap_main = kargs[3], kargs[4], kargs[2], kkw["ub_cap"]
    m_, nb_, p_ = qps.shape[0], lo.shape[0], qps.shape[1]
    bm_ = kkw["bm"]
    n_pre = prescan_blocks(10, kkw["bn"], nb_, eng.warm_start_blocks)
    bb = block_bounds(qps, lo, hi, cap_main)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bb_plain = block_bounds_plain(qps, lo, hi, cap_main)
    torch.cuda.synchronize()
    bb_plain_ms = (time.perf_counter() - t0) * 1e3
    bb_err = bounds_diff(bb, bb_plain)
    check(bb_err == 0 and torch.equal(bb, bb_plain),
          f"block_bounds differs from its plain version (max |diff| {bb_err})")
    del bb, bb_plain
    # the kernels' branch-free root against __fsqrt_rn, every float of its domain
    sqrt_bad = sqrt_mismatches()
    log(f"[kernels] branch-free square root vs __fsqrt_rn, every float of its "
        f"domain: {sqrt_bad} mismatches (zero-safe, nonzero variant)")
    check(sqrt_bad == (0, 0), f"the kernels' square root differs from __fsqrt_rn: {sqrt_bad}")
    sel_runs = {}
    # past the engine's select route too: where the two routes cross
    wide_n_pre = (SELECT_ROUTE_MAX_N_PRE + 1, 64)
    for npre in sorted({n_pre, SELECT_ROUTE_MAX_N_PRE, *wide_n_pre}):
        got_s = block_bounds_select(qps, lo, hi, cap_main, bm=bm_, n_pre=npre)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_s = block_bounds_select_plain(qps, lo, hi, cap_main, bm=bm_, n_pre=npre)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        old_s = matrix_route(qps, lo, hi, cap_main, bm=bm_, n_pre=npre)
        eq = [torch.equal(got_s[i], want_s[i]) and torch.equal(old_s[i], want_s[i])
              for i in (0, 1)]
        sel_runs[npre] = {"plain_ms": plain_ms, "tile_max_equal": eq[0],
                          "best_equal": eq[1],
                          "tile_max_err": bounds_diff(got_s[0], want_s[0])}
        log(f"[kernels] block_bounds_select n_pre={npre}: tile_max equal {eq[0]}, "
            f"best equal {eq[1]} (kernel, plain and old route), plain {plain_ms:.1f} ms")
        check(all(eq), f"block_bounds_select n_pre={npre} differs from its plain "
                       f"version or the old route")
        del got_s, want_s, old_s
    # in turns: the matrix mode, the old route, the select mode
    timing = {"bounds": [], "old_route": [], "select": []}
    for _ in range(REPS):
        timing["bounds"] += cuda_ms(lambda: block_bounds(qps, lo, hi, cap_main), 1)
        timing["old_route"] += cuda_ms(lambda: matrix_route(
            qps, lo, hi, cap_main, bm=bm_, n_pre=n_pre), 1)
        timing["select"] += cuda_ms(lambda: block_bounds_select(
            qps, lo, hi, cap_main, bm=bm_, n_pre=n_pre), 1)
    # in turns, at prescans past the engine's select route: the old route
    # against the select mode
    wide_ms = {f"{route}_n{w}": [] for w in wide_n_pre
               for route in ("old_route", "select")}
    for _ in range(REPS):
        for w in wide_n_pre:
            wide_ms[f"old_route_n{w}"] += cuda_ms(lambda: matrix_route(
                qps, lo, hi, cap_main, bm=bm_, n_pre=w), 1)
            wide_ms[f"select_n{w}"] += cuda_ms(lambda: block_bounds_select(
                qps, lo, hi, cap_main, bm=bm_, n_pre=w), 1)
    timing.update(wide_ms)
    med = {name: float(np.median(v)) for name, v in timing.items()}
    # kernel_inputs through the old route and the new one, in turns: the
    # same outputs, and the time of the whole stage
    ki_args = (eng.index, qn, qp, 10)
    ki_kw = dict(bm=eng.bm, bn=eng.bn, warm_start=eng.warm_start,
                 best_first=eng.best_first, margin=eng.margin,
                 warm_start_blocks=eng.warm_start_blocks, n_pivots=eng.n_pivots)
    same = kernel_inputs_equal(
        kernel_inputs_by_route(kernel_inputs, matrix_route, *ki_args, **ki_kw),
        kernel_inputs(*ki_args, **ki_kw))
    log(f"[kernels] kernel_inputs at the main path, old route vs block_bounds_select: "
        f"outputs equal {same}")
    check(same, "kernel_inputs differs between the old route and block_bounds_select")
    ki_ms = {"old_route": [], "select": []}
    for _ in range(REPS):
        ki_ms["old_route"] += cuda_ms(lambda: kernel_inputs_by_route(
            kernel_inputs, matrix_route, *ki_args, **ki_kw), 1)
        ki_ms["select"] += cuda_ms(lambda: kernel_inputs(*ki_args, **ki_kw), 1)
    ki_med = {name: float(np.median(v)) for name, v in ki_ms.items()}
    report["bound_stage"] = {"ms": timing, "kernel_inputs_ms": ki_ms, "n_pre": n_pre,
                             "select_checks": sel_runs, "sqrt_mismatches": sqrt_bad}
    log(f"[kernels] bound stage at n_pre={n_pre}, in turns: block_bounds "
        f"{med['bounds']:.3f} ms, old route (block_bounds + argsort + padded copy + "
        f"tile max) {med['old_route']:.3f} ms, block_bounds_select {med['select']:.3f} ms; "
        f"kernel_inputs old route {ki_med['old_route']:.3f} ms, new "
        f"{ki_med['select']:.3f} ms")
    for w in wide_n_pre:
        log(f"[kernels] bound stage at n_pre={w}, in turns: old route "
            f"{med[f'old_route_n{w}']:.3f} ms, block_bounds_select "
            f"{med[f'select_n{w}']:.3f} ms")
    cap_bytes = 0 if cap_main is None else 4 * m_ * nb_
    in_bytes = 4 * (m_ * p_ + 2 * nb_ * p_) + cap_bytes
    bound_note = "none: no single PyTorch call computes the Eq. 13 interval bound"
    bb_entry = {
        "name": "block_bounds", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_bounds.cu",
        "replaces": "src/repro/kernels/bound_prune.py:58",
        "launches": launches["block_bounds"], "max_abs_err": bb_err,
        "ms": med["bounds"], "plain_ms": bb_plain_ms,
        # the ops: Eq. 13, and per (query, block) the empty-block select
        **bound_entry(in_bytes + 4 * m_ * nb_,
                      eq13_ops(m_, nb_, p_) + float(m_) * nb_),
        "library_ms": None, "library": bound_note, "ms_all": timing["bounds"]}
    sel_entry = {
        "name": "block_bounds_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_bounds.cu",
        "replaces": "src/repro/kernels/bound_prune.py:58",
        "launches": launches["block_bounds_select"],
        "max_abs_err": sel_runs[n_pre]["tile_max_err"],
        "ms": med["select"], "plain_ms": sel_runs[n_pre]["plain_ms"],
        # block_bounds' operations, plus per (query, block) the max into
        # tile_max and one comparison for the top n_pre; bytes of the
        # inputs, tile_max and best
        **bound_entry(in_bytes + 4 * (-(-m_ // bm_)) * nb_ + 8 * m_ * n_pre,
                      eq13_ops(m_, nb_, p_) + 3.0 * m_ * nb_),
        "library_ms": None, "library": bound_note, "n_pre": n_pre,
        "covers": "one launch runs two kernels, select_kernel and "
                  "select_merge_kernel; ms and launches count both",
        "old_route_ms": med["old_route"], "ms_all": timing["select"],
        "old_route_ms_all": timing["old_route"],
        "kernel_inputs_ms": ki_med["select"],
        "kernel_inputs_old_route_ms": ki_med["old_route"]}
    for e in (bb_entry, sel_entry):
        log(f"[kernels] {e['name']} [{m_} x {nb_} x {p_}]: max |diff| "
            f"{e['max_abs_err']:.3e}, kernel {e['ms']:.3f} ms, plain "
            f"{e['plain_ms']:.1f} ms, bound {e['bound_ms']:.3f} ms ({e['bound_by']})")
    # phase 7 reads phase 3's index, queries and brute force
    eng64, q64 = eng, q
    del kargs, kkw, qn, qp, eng, q
    torch.cuda.empty_cache()

    # 5c. small cases: ub_cap, element stats, holes in row_valid, k = bn,
    # empty-block sentinels
    rng = np.random.default_rng(args.seed + 1)
    small = SearchEngine.build(synth(dict(CLUSTERED64, n=SMALL_N, m=300), args.seed + 1)[0],
                               n_pivots=16, block_size=128)
    idx = small.index
    holes = idx.valid & torch.from_numpy(rng.uniform(size=idx.valid.shape[0]) > 0.1).cuda()
    idx = idx._replace(valid=holes)
    qs = torch.from_numpy(rng.standard_normal((300, 100), dtype=np.float32)).cuda()
    qs = qs + idx.db[torch.from_numpy(rng.integers(0, SMALL_N - 1000, 300)).cuda()] * 10
    sqn, sqp = prep_queries(idx, qs)
    db768, q768 = synth(dict(CLUSTERED64, n=SMALL_N, d=768, m=300), args.seed + 4)
    wide = SearchEngine.build(db768, n_pivots=16, block_size=128).index
    wqn, wqp = prep_queries(wide, torch.from_numpy(q768).cuda())
    cases = {}
    # each at splits 1, 3 and the engine's choice; 157 db tiles, so 3 and
    # most choices leave short splits (nt % S != 0)
    for name, ix, cq, cp, k, extra in [
            ("ub_cap+elem+holes", idx, sqn, sqp, 10, dict(n_pivots=8, element_stats=True)),
            ("k=bn", idx, sqn, sqp, 128, dict()),
            ("no_prune", idx, sqn, sqp, 5, dict(prune=False)),
            ("d=768", wide, wqn, wqp, 10, dict()),
            ("m=50", idx, sqn[:50], sqp[:50], 10, dict())]:
        a_, kw_, _ = kernel_inputs(ix, cq, cp, k, bm=128, warm_start=True,
                                   best_first=True, **extra)
        nt_ = a_[3].shape[0]
        for s in sorted({1, 3, kw_["splits"]}):
            kws = dict(kw_, splits=s)
            r = check_topk(pruned_topk(*a_, **kws), pruned_topk_plain(*a_, **kws), a_,
                           kws, 1e-5, pruned_topk_plain)
            r["ragged"] = nt_ % s != 0
            cases[f"{name} splits={s}"] = r
            log(f"[kernels] pruned_topk small case {name}, splits={s} of {nt_} "
                f"tiles: {r}")
            check(topk_ok(r, 1e-5), f"pruned_topk small case {name} splits={s} "
                                    f"disagrees: {r}")
    check(any(c["ragged"] for c in cases.values()), "no case with nt % splits != 0")
    del wide, wqn, wqp
    lo_s, hi_s = idx.dp_min.clone(), idx.dp_max.clone()
    lo_s[::7], hi_s[::7] = float("inf"), float("-inf")
    cap = torch.rand(sqp.shape[0], lo_s.shape[0], device="cuda") + 0.5
    # NaN in qp, lo and the cap, and qp = 0 against [-inf, -inf]
    nqp, nlo, nhi, ncap = sqp.clone(), lo_s.clone(), hi_s.clone(), cap.clone()
    nqp[5, 2], nlo[8, 1], ncap[9, 11] = float("nan"), float("nan"), float("nan")
    nqp[20:30, 0], nlo[13, 0], nhi[13, 0] = 0.0, float("-inf"), float("-inf")
    # 300 queries: ragged at bm = 128 and bm = 8
    for name, ops in [("sentinel", (sqp, lo_s, hi_s, None)),
                      ("sentinel+cap", (sqp, lo_s, hi_s, cap)),
                      ("nan", (nqp, nlo, nhi, ncap))]:
        got_b, want_b = block_bounds(*ops), block_bounds_plain(*ops)
        ok = bounds_equal(got_b, want_b) and bool(torch.isneginf(got_b[:, ::7]).all())
        clean = ~torch.isnan(want_b).any(1)
        for bm_s in (8, 128):
            got_s = block_bounds_select(*ops, bm=bm_s, n_pre=3)
            want_s = block_bounds_select_plain(*ops, bm=bm_s, n_pre=3)
            ok = (ok and bounds_equal(got_s[0], want_s[0])
                  and torch.equal(got_s[1][clean], want_s[1][clean])
                  and nan_first(got_s[1], want_b))
        cases[f"block_bounds {name}"] = {"equal": ok, "rows_with_nan": int((~clean).sum())}
        log(f"[kernels] block_bounds and block_bounds_select, {name} case: "
            f"{cases[f'block_bounds {name}']}")
        check(ok, f"block_bounds or block_bounds_select disagrees in the {name} case")
    report["small_cases"] = cases
    del small, idx

    # 3b. the main path's shape where the bound skips nothing
    report["clustered2048"] = phase_search(CLUSTERED2048, args.seed + 3,
                                           SearchEngine, kernels, absent=absent)[2]
    torch.cuda.empty_cache()

    # 4. K-loop over D = 256 and the worst case for the bound
    eng256, q256, report["uniform256"], brute256 = phase_search(
        UNIFORM256, args.seed + 2, SearchEngine, kernels, absent=absent)

    # 7. the scan and tree backends on phase 3's and phase 4's indexes
    t7 = time.perf_counter()
    st_kernels = (block_bounds, block_bounds_select, pruned_topk)
    phase7 = {}
    for spec, e, qq, brute, key in ((CLUSTERED64, eng64, q64, brute64, "clustered64"),
                                    (UNIFORM256, eng256, q256, brute256, "uniform256")):
        kprune = {k: report[key][f"k{k}"]["block_prune_frac"] for k in spec["ks"]}
        phase7[key], tree = phase_scan_tree(
            spec, e, qq, brute, spec["ks"], kprune, st_kernels,
            profile=("tree_k10",) if key == "uniform256" else ())
        if key == "clustered64":
            phase7["node_tables"] = node_table_checks(
                tree, prep_queries(e.index, qq)[1], (1, tree.n_levels // 2, tree.n_levels))
        del tree
        torch.cuda.empty_cache()
    phase7["seconds"] = time.perf_counter() - t7
    report["scan_tree"] = phase7
    log(f"[scan/tree] phase 7: {phase7['seconds']:.1f} s")

    # 8. the tree's kernel leaf stage on the same indexes and queries, and
    # on one query tile of clustered-64 queries
    t8 = time.perf_counter()
    phase8 = {}
    kp50 = {key: {k: report[key][f"k{k}"]["p50_ms"] for k in spec["ks"]}
            for key, spec in (("clustered64", CLUSTERED64), ("uniform256", UNIFORM256))}
    phase8["clustered64"], tree_eng = phase_tree_kernel(
        CLUSTERED64, eng64, q64, brute64, CLUSTERED64["ks"], kp50["clustered64"],
        st_kernels, profile=("tree_kernel_k10",))
    phase8["uniform256"] = phase_tree_kernel(
        UNIFORM256, eng256, q256, brute256, UNIFORM256["ks"], kp50["uniform256"],
        st_kernels)[0]
    qt = q64[:TILE_BATCH]
    eng64.search(qt, 10)
    tile_kernel_p50 = float(np.median(cuda_ms(lambda: eng64.search(qt, 10), REPS)))
    phase8["clustered64_one_tile"] = phase_tree_kernel(
        dict(CLUSTERED64, name=f"clustered-64, one query tile of {TILE_BATCH}",
             m=TILE_BATCH), eng64, qt, {10: tuple(x[:TILE_BATCH] for x in brute64[10])},
        (10,), {10: tile_kernel_p50}, st_kernels, prefix="tree_kernel_tile")[0]
    gather_entry = gathered_entry(eng64, tree_eng, q64, phase8)
    phase8["seconds"] = time.perf_counter() - t8
    report["tree_kernel"] = phase8
    log(f"[tree kernel leaves] phase 8: {phase8['seconds']:.1f} s")
    del tree_eng

    # 9. soundness near +-1 at full size on the clustered-64 index
    t9 = time.perf_counter()
    report["near_pm1"] = phase_near_pm1(eng64, args.seed + 5, st_kernels)
    report["near_pm1"]["seconds"] = time.perf_counter() - t9
    log(f"[near +-1] phase 9: {report['near_pm1']['seconds']:.1f} s")
    del eng256, q256, brute256
    torch.cuda.empty_cache()

    # 15. the sharded search layer on phase 3's corpus, held to phase 3's
    # brute force and engine while they are at hand
    report["sharded"] = phase_sharded(
        CLUSTERED64, args.seed, eng64, q64, brute64, SearchEngine,
        (pruned_topk, block_bounds_select, block_bounds, merge_splits), card)
    sharded = report["sharded"]["launches"]
    log(f"[prune] sharded k10: block_prune_frac "
        f"{report['sharded']['flat'][10]['block_prune_frac']:.4f} flat, "
        f"{report['sharded']['trees'][10]['block_prune_frac']:.4f} with the shard trees "
        f"(single-device engine: {report['clustered64']['k10']['block_prune_frac']:.4f})")
    torch.cuda.empty_cache()

    # 10. online mutation at full size on copies of phase 3's index
    report["online"], online_eng, live = phase_online(
        eng64, q64, brute64, args.seed, args.seed + 5, st_kernels,
        report["clustered64"]["k10"]["block_prune_frac"])
    del brute64
    torch.cuda.empty_cache()

    # 11. single-device serving: the batcher over phase 10's engine, the
    # kNN-LM datastore over phase 3's, dedup; then the merge at its batches
    report["serving"] = phase_serving(online_eng, live, eng64, q64, args.seed + 7, args.seed,
                                      (pruned_topk, block_bounds_select, block_bounds,
                                       merge_splits))
    report["serving"]["merge_small_batches"] = small_batch_merge(
        online_eng, q64, _launch, _operands, merge_splits)
    del eng64, q64, online_eng, live
    torch.cuda.empty_cache()

    # 12. kNN-LM serving through the port's model at full width
    report["knn_lm"] = phase_knnlm(args.seed + 11, card, (pruned_topk, block_bounds_select,
                                                         block_bounds, merge_splits))
    knn_lm = report["knn_lm"]["launches"]

    # 13. kNN-LM serving across the model families at full width
    report["families"] = phase_families(args.seed + 13, card, (pruned_topk, block_bounds_select,
                                                              block_bounds, merge_splits))
    families = report["families"]["launches"]

    # 14. training at full width: dedup -> train -> serve, restart, the
    # card's gradients against the CPU's, compression, the families
    report["train"] = phase_train(args.seed + 14, card, (pruned_topk, block_bounds_select,
                                                        block_bounds, merge_splits))
    train = report["train"]["launches"]

    # 16. training on a (data, model) mesh: one-rank meshes, the sharded
    # MoE, sharded restore, a search over several mesh dims
    report["mesh"] = phase_mesh_train(args.seed + 16, card, (pruned_topk, block_bounds_select,
                                                            block_bounds, merge_splits),
                                      report["train"]["train"]["ms_median"])
    mesh_train = report["mesh"]["launches"]["mesh_train"]
    mesh_search = report["mesh"]["launches"]["mesh_search"]

    # 17b-c. the dry-run: its prediction against the card, production cells
    report["dryrun"] = phase_dryrun(args.seed + 17, card, procs,
                                    (pruned_topk, block_bounds_select, block_bounds,
                                     merge_splits))

    # every configuration's block_prune_frac beside the point bound's
    for key, runs in POINT_BOUND_PRUNE.items():
        for name, old in runs.items():
            if key == "scan_tree":
                for cfg, was in old.items():
                    now = report["scan_tree"][name][cfg]["block_prune_frac"]
                    log(f"[prune] {name} {cfg}: block_prune_frac {now:.4f} (point bound: "
                        f"{was:.4f})")
                continue
            now = report[key][name]["block_prune_frac"]
            was = "not recorded" if old is None else f"{old:.4f}"
            log(f"[prune] {key} {name}: block_prune_frac {now:.4f} (point bound: {was})")
    tree_launches = sum(r["launches"]["block_bounds"] for key in ("clustered64", "uniform256")
                        for name, r in phase7[key].items() if name.startswith("tree"))
    scan_launches = sum(r["launches"]["block_bounds"] for key in ("clustered64", "uniform256")
                        for name, r in phase7[key].items() if name.startswith("scan"))
    tk_bb = sum(r["launches"]["block_bounds"] for part in phase8.values()
                if isinstance(part, dict) for r in part.values())
    bb_entry["launches_by_path"] = {"wide_prescan": bb_entry["launches"],
                                    "tree": tree_launches, "scan": scan_launches,
                                    "tree_kernel_leaves": tk_bb}
    bb_entry["tree_node_tables"] = phase7["node_tables"]
    online, serving = report["online"]["launches"], report["serving"]["launches"]
    topk_entry["launches_by_path"] = {"main": topk_entry["launches"],
                                      "sharded": sharded["pruned_topk"],
                                      "tree_kernel_leaves": gather_entry["launches"],
                                      "online_kernel": online["kernel"]["pruned_topk"],
                                      "online_tree": online["tree"]["pruned_topk"],
                                      "serving": serving["pruned_topk"],
                                      "knn_lm": knn_lm["pruned_topk"],
                                      "model_families": families["pruned_topk"],
                                      "train": train["pruned_topk"],
                                      "mesh_train": mesh_train["pruned_topk"],
                                      "mesh_search": mesh_search["pruned_topk"]}
    topk_entry["launches"] = sum(topk_entry["launches_by_path"].values())
    # the epilogue runs in every pruned_topk launch
    merge_entry["launches_by_path"] = dict(topk_entry["launches_by_path"])
    merge_entry["launches"] = topk_entry["launches"]
    gather_entry["launches_by_path"] = {"tree_kernel_leaves": gather_entry["launches"],
                                        "online_tree": online["tree"]["pruned_topk"],
                                        "sharded": report["sharded"]["gathered_launches"]}
    gather_entry["launches"] = sum(gather_entry["launches_by_path"].values())
    bb_entry["launches_by_path"].update(
        online_tree=online["tree"]["block_bounds"],
        online_kernel=online["kernel"]["block_bounds"], serving=serving["block_bounds"],
        sharded=sharded["block_bounds"],
        knn_lm=knn_lm["block_bounds"], model_families=families["block_bounds"],
        train=train["block_bounds"], mesh_train=mesh_train["block_bounds"],
        mesh_search=mesh_search["block_bounds"])
    bb_entry["launches"] = sum(bb_entry["launches_by_path"].values())
    sel_entry["launches_by_path"] = {
        "main": sel_entry["launches"], "sharded": sharded["block_bounds_select"],
        "online_kernel": online["kernel"]["block_bounds_select"],
        "online_tree": online["tree"]["block_bounds_select"],
        "serving": serving["block_bounds_select"], "knn_lm": knn_lm["block_bounds_select"],
        "model_families": families["block_bounds_select"],
        "train": train["block_bounds_select"],
        "mesh_train": mesh_train["block_bounds_select"],
        "mesh_search": mesh_search["block_bounds_select"]}
    sel_entry["launches"] = sum(sel_entry["launches_by_path"].values())

    report["kernels"] = [topk_entry, merge_entry, bb_entry, sel_entry, gather_entry,
                         bf16_entry]
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=float))
    log(f"[done] {report['seconds']:.1f} s; full report in {args.out}")
    print(card)
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
