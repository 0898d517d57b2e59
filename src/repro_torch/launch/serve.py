"""Serving driver: batched prefill+decode with optional kNN-LM retrieval
(counterpart of :mod:`repro.launch.serve`; its flags and defaults, plus
``--device``).

On the GPU (the default)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 8 --prompt-len 32 --gen 16 --knn

Demo (CPU, the kernels' plain versions), any of the ten archs of
``configs/archs.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --knn
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --smoke --device cpu --knn
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--knn", action="store_true", help="enable kNN-LM")
    ap.add_argument("--search-backend", default="auto",
                    choices=["auto", "scan", "kernel", "brute"],
                    help="SearchEngine backend for the datastore "
                         "(sharded needs a mesh launcher, not this driver)")
    ap.add_argument("--lmbda", type=float, default=0.25)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model, the datastore and its search "
                         "('cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model_fns, synthetic_batch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.knnlm import KNNDatastore

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    fns = model_fns(cfg)
    params = fns.init(0, device=dev)

    knn = None
    if args.knn:
        corpus = [synthetic_batch(cfg, 4, args.prompt_len, seed=s, device=dev)
                  for s in range(4)]
        t0 = time.perf_counter()
        knn = KNNDatastore.from_corpus(fns, params, corpus, cfg.vocab, k=8,
                                       n_pivots=8, block_size=64,
                                       backend=args.search_backend, device=dev)
        sync()
        print(f"datastore: {knn.index.db.shape[0]} keys, "
              f"backend={knn.engine.backend_name} "
              f"({time.perf_counter() - t0:.1f}s to build)")

    # the cache also holds a VLM's vision prefix (the reference's cache of
    # prompt + gen + 8 slots cannot take it at the full vision_seq)
    eng = Engine(fns, params, max_seq=cfg.vision_seq + args.prompt_len + args.gen + 8,
                 knn=knn, lmbda=args.lmbda)
    batch = synthetic_batch(cfg, args.requests, args.prompt_len, seed=42, device=dev)

    t0 = time.perf_counter()
    cache, clen, _ = eng.prefill(batch)
    sync()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], args.gen,
                         temperature=args.temperature)
    sync()
    t_decode = time.perf_counter() - t0

    n_prompt = args.requests * args.prompt_len
    n_gen = args.requests * args.gen
    print(f"prefill: {n_prompt} tokens in {t_prefill:.2f}s "
          f"({n_prompt / t_prefill:.0f} tok/s) on {dev}")
    print(f"decode:  {n_gen} tokens in {t_decode:.2f}s "
          f"({n_gen / t_decode:.0f} tok/s, knn={'on' if knn else 'off'})")
    print("sample generations (token ids):")
    for r in range(min(4, args.requests)):
        print(f"  req{r}: {toks[r].tolist()}")
    return toks


if __name__ == "__main__":
    main()
