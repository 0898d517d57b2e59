"""Training driver (counterpart of :mod:`repro.launch.train`; its flags and
defaults, plus ``--device``).

On the GPU (the default), at full width::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 30 --batch 8 --seq 1024

Demo (CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 50 --batch 8 --seq 64

It builds the train step (AdamW, ``warmup_cosine``, optional accumulation
and int8 gradient compression) and runs the Trainer with async
checkpointing, preemption handling and the straggler watchdog.  Only
``--mesh host`` runs: the pod meshes wait for the port of
``launch/mesh.py``, ``dist/sharding.py`` and ``launch/dryrun.py``
(ROADMAP).
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"),
                    help="checkpoint directory (the reference's /tmp/repro_train, "
                         "under $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to an int32 token file")
    ap.add_argument("--mesh", default="host",
                    help="host (pod and multipod wait for the port of dist/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the optimizer state")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh} waits for the port of launch/mesh.py, dist/sharding.py "
            "and launch/dryrun.py (ROADMAP); only --mesh host runs")

    from functools import partial

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.data.pipeline import SyntheticLM, TokenFileSource
    from repro_torch.models import model_fns
    from repro_torch.optim import schedule
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    fns = model_fns(cfg)

    step_fn = make_train_step(
        fns, cfg,
        lr_schedule=partial(schedule.warmup_cosine, peak_lr=args.lr,
                            warmup_steps=max(args.steps // 20, 5),
                            total_steps=args.steps),
        accum=args.accum, compress_grads=args.compress_grads)
    state = init_state(fns, 0, compress_grads=args.compress_grads, device=args.device)

    if args.data == "synthetic":
        data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    else:
        data = TokenFileSource(args.data, args.seq, args.batch, seed=0)

    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(step_fn, state, data, tc)
    out = trainer.run()
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"done: step {out['final_step']}, "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
