#!/usr/bin/env python
"""Where an MoE's bf16 gap between cache decode and teacher forcing comes
from, on the PyTorch port: chip_smoke.py's check b for an MoE
(``moe_replay``: the teacher's expert choices replayed into the cache path)
at several depths of one arch at full width, on the GPU and on the host's
CPU, each beside the float32 computation.

    python tools/moe_teacher_forcing.py [--arch granite-moe-1b-a400m]
        [--depths 4 8 16 24] [--cpu-depths 4 8 16 24] [--out FILE]
    python tools/moe_teacher_forcing.py --smoke --device cpu   # a quick try

The model is ARCHS[arch] with random weights from ``--seed`` on
``--device``; depth n runs its first n layers (the same weights).  The
prompts and the greedy tokens are chip_smoke.py phase 13's (its seeds, B =
8 prompts of 256 tokens, 32 tokens decoded through Engine in bf16 at full
depth).  For each depth, rows of:

  bf16       check b: teacher and cache path in bf16, the bf16 teacher's
             own experts replayed into the path
  fp32       both paths in float32 activations with those experts; its
             teacher is the ``truth`` of the other rows
  bf16_rr0   as bf16, with torch's reduced-precision reduction in bf16
             GEMMs off (CUDA only)
  bf16_cpu   as bf16 on the CPU: the same weights, inputs and experts

Each row gives max |logit diff| over the truth's logit std for teacher
against path (``path``, what check b reads), teacher against truth and path
against truth, and the seconds it took.  One JSON object per row is
printed, and all of them are written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import model_fns, synthetic_batch  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402


def rel(got, want, std):
    return float((got.float() - want.float()).abs().max()) / std


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 8, 16, 24])
    ap.add_argument("--cpu-depths", type=int, nargs="*", default=[4, 8, 16, 24])
    ap.add_argument("--seed", type=int, default=13, help="chip_smoke.py phase 13's")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--out", default="build/moe_teacher_forcing.json")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    cfg = cfg.replace(dtype="bfloat16")
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = model_fns(cfg)
    params = fns.init(args.seed, device=dev)
    b, p, g = cs.KNNLM_REQUESTS[0], cs.KNNLM_PROMPT, cs.KNNLM_GEN
    if args.smoke:
        p, g = 16, 4
    batch = synthetic_batch(cfg, b, p, seed=args.seed + 2000 + b, device=dev)
    eng = Engine(fns, params, max_seq=p + g + 8)
    cache, clen, _ = eng.prefill(batch)
    toks, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], g)
    del eng, cache
    prompt = batch["tokens"]
    rows, truth = [], {}

    def row(depth, name, run, t0):
        std = float(truth[depth].float().std())
        r = {"arch": cfg.name, "depth": depth, "run": name, "device": str(run["want"].device),
             "path": rel(run["got"], run["want"], std),
             "teacher_vs_truth": rel(run["want"].to(truth[depth].device), truth[depth], std),
             "path_vs_truth": rel(run["got"].to(truth[depth].device), truth[depth], std),
             "logit_std": std, "routing_differs": run["flips"], "of_pairs": run["of_pairs"],
             "seconds": time.perf_counter() - t0}
        rows.append(r)
        print(json.dumps(r), flush=True)

    experts = {}
    for n in args.depths:
        c = cfg.replace(n_layers=n)
        t0 = time.perf_counter()
        bf = cs.moe_replay(params, c, prompt, toks)
        t1 = time.perf_counter()
        f32 = cs.moe_replay(params, c.replace(dtype="float32"), prompt, toks,
                            experts=bf["experts"])
        truth[n] = f32["want"]
        row(n, "fp32", f32, t1)
        row(n, "bf16", bf, t0)
        experts[n] = [e.cpu() for e in bf["experts"]]
        del bf, f32
        if dev.type == "cuda":
            t0 = time.perf_counter()
            old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            try:
                row(n, "bf16_rr0", cs.moe_replay(params, c, prompt, toks,
                                                 experts=experts[n]), t0)
            finally:
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old
    if args.cpu_depths and dev.type != "cpu":
        params = params.to("cpu")
        prompt, toks = prompt.cpu(), toks.cpu()
        for n in args.cpu_depths:
            t0 = time.perf_counter()
            row(n, "bf16_cpu", cs.moe_replay(params, cfg.replace(n_layers=n), prompt, toks,
                                             experts=experts[n]), t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"arch": cfg.name, "smoke": args.smoke, "seed": args.seed, "rows": rows,
                   "threads": torch.get_num_threads()}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
