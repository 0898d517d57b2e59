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
checkpointing, preemption handling and the straggler watchdog.

``--mesh pod|multipod`` (one process per device, e.g. under ``torchrun``,
256 or 512 ranks) builds the production mesh, installs
``default_rules(fsdp=True)``, places the parameters and the optimizer
state by ``launch.dryrun.param_shardings`` and makes each rank's batch a
DTensor of the global batch (``make_global``).  ``--batch`` is each data
shard's batch (the reference's process-local batch), so the global batch
is ``--batch`` times the data ranks; each data shard draws its own rows
(``ShardInfo``), and the model ranks of a shard draw the same.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch


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
                    help="host | pod (16x16) | multipod (2x16x16)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the optimizer state")
    args = ap.parse_args(argv)

    from functools import partial

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.data.pipeline import ShardInfo, SyntheticLM, TokenFileSource
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model_fns
    from repro_torch.optim import schedule
    from repro_torch.train.train_step import init_state, make_train_step, place_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    fns = model_fns(cfg)

    step_fn = make_train_step(
        fns, cfg,
        lr_schedule=partial(schedule.warmup_cosine, peak_lr=args.lr,
                            warmup_steps=max(args.steps // 20, 5),
                            total_steps=args.steps),
        accum=args.accum, compress_grads=args.compress_grads)
    device = args.device
    make_global, shard = None, ShardInfo()
    if args.mesh != "host":
        from repro_torch.core.distributed import shard_layout
        from repro_torch.dist.compat import make_process_local_array
        from repro_torch.launch.dryrun import param_shardings
        from repro_torch.launch.mesh import make_production_mesh

        multi = args.mesh == "multipod"
        mesh = make_production_mesh(multi_pod=multi, device_type=device)
        if mesh.device_type == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        shd.set_rules(mesh, shd.default_rules(multi_pod=multi, fsdp=True))
        dp = ("pod", "data") if multi else ("data",)
        n_dp, pos = shard_layout(mesh, dp)
        shard = ShardInfo(pos, n_dp)
        batch_sh = shd.NamedSharding(mesh, (dp,))

        def make_global(b):
            # each data shard's rows, the global batch n_dp times as long
            return {k: make_process_local_array(batch_sh, x,
                                                (x.shape[0] * n_dp,) + x.shape[1:])
                    for k, x in b.items()}
    state = init_state(fns, 0, compress_grads=args.compress_grads, device=device)
    if args.mesh != "host":
        state = place_state(state, param_shardings(state["params"], mesh, cfg))

    global_batch = args.batch * shard.num_shards
    if args.data == "synthetic":
        data = SyntheticLM(cfg.vocab, args.seq, global_batch, seed=0, shard=shard)
    else:
        data = TokenFileSource(args.data, args.seq, global_batch, seed=0, shard=shard)

    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(step_fn, state, data, tc, make_global=make_global)
    out = trainer.run()
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"done: step {out['final_step']}, "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
