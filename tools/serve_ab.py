"""Time one checkout's kNN-LM serving on the card, to compare two commits.

For the checkout given (default: the one this file is in) it runs that
checkout's own ``chip_smoke.py`` phase 12 (tinyllama-1.1b at full width:
prefill and greedy decode at B = 8 and 64, kNN off and on) and phase 13
for the archs given, and times that checkout's ``flash_attention`` at
phase 12's prefill and decode shapes: the wall time per call, the card's
busy time per call under torch.profiler, and the allocations per call.
It writes one JSON object, with the card's name and power limit.

Host time varies from machine to machine, so compare two checkouts only
within one call, alternating them on the same card; with the parent
unpacked by ``git archive`` under ``build/parent``:

    python tools/serve_ab.py --checkout build/parent --out build/ab_parent1.json
    python tools/serve_ab.py --out build/ab_change1.json
    python tools/serve_ab.py --out build/ab_change2.json
    python tools/serve_ab.py --checkout build/parent --out build/ab_parent2.json

Each run builds the checkout's kernels first (cached under its build/).
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

#: calls per timing of flash_attention; the profiler's share of them
CALLS, PROFILED = 50, 10


def attention_timings(chip_smoke, cfg) -> dict:
    """flash_attention of the checkout at phase 12's shapes, under
    inference mode: prefill over the prompt, and one decode step over the
    cache half way through the generation, at each batch of phase 12."""
    from repro_torch.models.layers import flash_attention

    dev, dt = torch.device("cuda"), cfg.act_dtype
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    prompt, gen = chip_smoke.KNNLM_PROMPT, chip_smoke.KNNLM_GEN
    smax, at = prompt + gen + 8, prompt + gen // 2
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    out = {}
    for b in chip_smoke.KNNLM_REQUESTS:
        shapes = {
            "prefill": (rand(b, prompt, h, dh), rand(b, prompt, kv, dh), rand(b, prompt, kv, dh),
                        dict(causal=True, chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)),
            "decode": (rand(b, 1, h, dh), rand(b, smax, kv, dh), rand(b, smax, kv, dh),
                       dict(causal=True, q_offset=at,
                            kv_valid=(torch.arange(smax, device=dev) < at + 1).expand(b, smax),
                            chunk_q=8, chunk_k=cfg.attn_chunk_k))}
        for what, (q, k, v, kw) in shapes.items():
            def call():
                return flash_attention(q, k, v, **kw)

            with torch.inference_mode():
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    call()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
                n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
                for _ in range(PROFILED):
                    call()
                allocs = (torch.cuda.memory_stats()["allocation.all.allocated"] - n0) / PROFILED
                busy = chip_smoke.device_busy(lambda: [call() for _ in range(PROFILED)],
                                              wall_ms * PROFILED, top=4)
            out[f"{what}_b{b}"] = {"wall_ms": wall_ms, "busy_ms": busy["busy_ms"] / PROFILED,
                                   "device_events": busy["kernels"] / PROFILED,
                                   "allocations": allocs, "top": busy["top"]}
            chip_smoke.log(f"[ab] flash_attention {what} B = {b}: {wall_ms:.3f} ms a call, "
                           f"card busy {busy['busy_ms'] / PROFILED:.3f} ms, "
                           f"{busy['kernels'] / PROFILED:.0f} device events, "
                           f"{allocs:.0f} allocations")
    return out


def runs_of(report) -> list:
    keys = ("requests", "knn", "prefill_tok_s", "decode_tok_s", "step_ms", "model_ms_per_step",
            "knn_ms_per_step")
    return [{k: r[k] for k in keys if k in r} for r in report["runs"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parents[1]),
                    help="the root of the checkout to time")
    ap.add_argument("--archs", default="granite-moe-1b-a400m",
                    help="phase 13's archs, comma-separated ('' for none)")
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    ap.add_argument("--out", required=True, help="where the JSON object is written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    root = Path(args.checkout).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    chip_smoke = importlib.import_module("chip_smoke")
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels.bound_prune import block_bounds, block_bounds_select
    from repro_torch.kernels.cosine_topk import merge_splits, pruned_topk

    card = subprocess.run(  # repro-lint: disable=R003 -- nvidia-smi, not python
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    chip_smoke.log(f"[ab] {root} on {card}")
    t0 = time.perf_counter()
    _build.build()
    kernels = (pruned_topk, block_bounds_select, block_bounds, merge_splits)
    out = {"checkout": str(root), "card": card, "build_s": time.perf_counter() - t0,
           "attention": attention_timings(chip_smoke, ARCHS[chip_smoke.KNNLM_ARCH])}
    out["knn_lm"] = runs_of(chip_smoke.phase_knnlm(args.seed + 11, card, kernels))
    archs = tuple(a for a in args.archs.split(",") if a)
    if archs:
        fam = chip_smoke.phase_families(args.seed + 13, card, kernels, archs=archs)
        out["families"] = {a: runs_of(fam["models"][a]) for a in archs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("checkout", "card", "knn_lm")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
