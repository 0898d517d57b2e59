"""Training loop with checkpoint/restart, straggler watchdog, preemption
(counterpart of :mod:`repro.train.trainer`).

* **checkpoint/restart** — CheckpointManager snapshots (params, opt, step,
  data state) every ``ckpt_every`` steps asynchronously; on start the
  trainer restores the latest complete checkpoint, so any crash loses at
  most ``ckpt_every`` steps.
* **preemption** — SIGTERM sets a flag; the loop finishes the in-flight
  step, writes a blocking checkpoint and exits 0.  Where the loop's last
  step was just saved asynchronously, the final checkpoint waits for that
  write instead of writing the same step again (the reference writes it
  twice: 13 GB more for a 1.1 B-parameter state).
* **straggler watchdog** — per-step wall time is tracked with an EMA;
  steps slower than ``straggler_factor`` x EMA are counted with their step
  index.  On CUDA each step is timed after ``torch.cuda.synchronize()``
  (the reference's ``block_until_ready``), so the watchdog times the card,
  not the launch queue.
* **elastic restart** — a checkpoint holds full arrays, so
  ``CheckpointManager.restore(shardings=...)`` places them onto any mesh;
  :func:`repro_torch.dist.elastic.remesh` picks the largest usable mesh
  over the surviving ranks.
* **make_global** — turns each host batch into what the train step takes:
  by default the numpy arrays on the model's device; on a mesh the
  launcher passes one that makes each rank's rows a DTensor of the global
  batch (``dist.compat.make_process_local_array``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    #: the reference's /tmp/repro_ckpt, under the process's temporary
    #: directory ($TMPDIR)
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1


class Trainer:
    def __init__(self, train_step: Callable, state, data_source,
                 cfg: TrainerConfig, *, make_global=None, hooks=()):
        self.train_step = train_step
        self.state = state
        self.data = data_source
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.make_global = make_global or self._to_device
        self.hooks = list(hooks)
        self._preempted = False
        self._ema = None
        self.straggler_steps: list[int] = []
        self.history: list[dict] = []

    def _to_device(self, batch: dict) -> dict:
        """The numpy batch on the model's device."""
        dev = self.state["params"].device
        return {k: torch.as_tensor(x, device=dev) for k, x in batch.items()}

    def _handle_preempt(self, *_):
        self._preempted = True

    def maybe_restore(self) -> int:
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        self.state, extra, step = self.ckpt.restore(self.state, step)
        if "data" in extra:
            self.data.restore(extra["data"])
        return int(step)

    def run(self, *, install_signal: bool = True) -> dict:
        if install_signal:
            try:
                signal.signal(signal.SIGTERM, self._handle_preempt)
            except ValueError:
                pass  # not main thread
        start = self.maybe_restore()
        step = saved = start
        while step < self.cfg.total_steps and not self._preempted:
            batch = self.make_global(self.data.batch(step))
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            if metrics["loss"].is_cuda:
                torch.cuda.synchronize(metrics["loss"].device)
            dt = time.perf_counter() - t0
            # straggler watchdog
            if self._ema is None:
                self._ema = dt
            else:
                if dt > self.cfg.straggler_factor * self._ema and step > start + 2:
                    self.straggler_steps.append(step)
                self._ema = (1 - self.cfg.ema_alpha) * self._ema + \
                    self.cfg.ema_alpha * dt
            step += 1
            rec = {"step": step, "time_s": dt,
                   **{k: float(v) for k, v in metrics.items()}}
            self.history.append(rec)
            for h in self.hooks:
                h(step, self.state, rec)
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                print(f"step {step:6d} loss {rec['loss']:.4f} "
                      f"({dt*1e3:.0f} ms, grad_norm {rec.get('grad_norm', 0):.2f})",
                      flush=True)
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, self.state,
                               extra={"data": self.data.state()})
                saved = step
        # final/preemption checkpoint is synchronous
        if saved == step and step > start:
            self.ckpt.wait()
        else:
            self.ckpt.save(step, self.state, extra={"data": self.data.state()},
                           block=True)
        return {"final_step": step, "preempted": self._preempted,
                "stragglers": self.straggler_steps, "history": self.history}
