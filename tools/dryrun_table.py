"""The dry-run's records as one markdown table (PERF.md's sweep table).

    python tools/dryrun_table.py [experiments/dryrun_torch]

Reads ``<dir>/<mesh>/<arch>__<shape>.json`` as
``python -m repro_torch.launch.dryrun --all --mesh both`` writes them and
prints one row per arch, one column per shape: the memory per rank
(argument + temporary bytes, GiB) on the pod and the multipod mesh, the
pod's FLOPs per rank and its collective bytes per rank (GiB, all kinds);
``SKIP`` or ``FAIL`` where the cell has no numbers.  Reads no module of
the repository.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod", "multipod")


def cell(root: Path, mesh: str, arch: str, shape: str) -> dict | None:
    path = root / mesh / f"{arch}__{shape}.json"
    return json.loads(path.read_text()) if path.exists() else None


def entry(recs: dict) -> str:
    pod = recs["pod"]
    if pod is None or any(r is None for r in recs.values()):
        return "not run"
    if pod.get("skipped"):
        return "SKIP"
    if any("error" in r for r in recs.values()):
        return "FAIL"
    mem = "/".join(f"{(r['memory']['argument_bytes'] + r['memory']['temp_bytes']) / 2**30:.1f}"
                   for r in recs.values())
    coll = sum(v["bytes"] for v in pod["collectives"].values()) / 2**30
    return f"{mem}; {pod['cost']['flops']:.2e}; {coll:.1f}"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else "experiments/dryrun_torch")
    archs = sorted({p.name.split("__")[0] for p in (root / "pod").glob("*.json")})
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in archs:
        row = [entry({m: cell(root, m, arch, s) for m in MESHES}) for s in SHAPES]
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
