"""Deterministic, resumable, host-sharded data pipeline (counterpart of
:mod:`repro.data.pipeline`, a copy of its numpy code: the same batches bit
for bit).

Two sources behind one interface:

* ``SyntheticLM`` — a stateless PRNG stream: batch(step) is a pure function
  of (seed, step, shard), so resume-after-preemption is exact with no state
  beyond the step counter, and every host generates only its own shard.
* ``TokenFileSource`` — fixed-width samples from a binary token file via
  ``np.memmap`` with a deterministic epoch shuffle (Feistel-style index
  permutation, O(1) state).

Both return host-local numpy arrays; the trainer moves them to the model's
device (:class:`repro_torch.train.trainer.Trainer`'s ``make_global``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ShardInfo", "SyntheticLM", "TokenFileSource"]


@dataclasses.dataclass
class ShardInfo:
    shard: int = 0
    num_shards: int = 1


class SyntheticLM:
    """Zipf-ish synthetic token stream with planted n-gram structure (so a
    model actually learns and loss decreases — used by examples/tests)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard: ShardInfo = ShardInfo()):
        assert global_batch % shard.num_shards == 0
        self.vocab, self.seq = vocab, seq_len
        self.local_batch = global_batch // shard.num_shards
        self.seed, self.shard = seed, shard

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard.shard]))
        b, s, v = self.local_batch, self.seq, self.vocab
        # order-2 markov-ish: next token = f(prev) + noise; cheap + learnable
        base = rng.zipf(1.5, size=(b, s)).astype(np.int64) % v
        tok = np.empty((b, s), np.int32)
        tok[:, 0] = base[:, 0]
        mult = 31
        for t in range(1, s):
            det = (tok[:, t - 1] * mult + 7) % v
            use_det = rng.random(b) < 0.7
            tok[:, t] = np.where(use_det, det, base[:, t])
        labels = np.roll(tok, -1, axis=1)
        labels[:, -1] = tok[:, 0]
        return {"tokens": tok, "labels": labels}

    def state(self) -> dict:
        return {"kind": "synthetic", "seed": self.seed}

    # stateless: nothing to restore beyond the trainer's step counter
    def restore(self, state: dict) -> None:
        assert state.get("kind") == "synthetic"


def _feistel(idx: np.ndarray, n: int, key: int, rounds: int = 4) -> np.ndarray:
    """Deterministic permutation of [0, n) (cycle-walking Feistel)."""
    bits = max(2, int(np.ceil(np.log2(max(n, 2)))))
    half = bits // 2
    mask = (1 << half) - 1
    out = idx.astype(np.uint64)

    def perm(x):
        l, r = x >> half, x & mask
        for rnd in range(rounds):
            f = ((r * np.uint64(0x9E3779B1) + np.uint64(key + rnd)) >>
                 np.uint64(15)) & mask
            l, r = r, l ^ f
        return (l << half) | r

    out = perm(out)
    for _ in range(4):  # cycle-walk back into range
        oob = out >= n
        if not oob.any():
            break
        out = np.where(oob, perm(out), out)
    return np.where(out >= n, idx, out).astype(np.int64)


class TokenFileSource:
    """Fixed-width samples from a flat binary int32 token file."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 seed: int = 0, shard: ShardInfo = ShardInfo()):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq = seq_len
        assert global_batch % shard.num_shards == 0
        self.local_batch = global_batch // shard.num_shards
        self.n_samples = len(self.data) // (seq_len + 1)
        self.seed, self.shard = seed, shard
        assert self.n_samples >= global_batch, "file too small"

    def batch(self, step: int) -> dict:
        gb = self.local_batch * self.shard.num_shards
        epoch = (step * gb) // self.n_samples
        offs = (step * gb) % self.n_samples
        idx = (offs + np.arange(gb)) % self.n_samples
        idx = _feistel(idx, self.n_samples, self.seed + epoch)
        lo = self.shard.shard * self.local_batch
        idx = idx[lo : lo + self.local_batch]
        w = self.seq + 1
        rows = np.stack([self.data[i * w : (i + 1) * w] for i in idx])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def state(self) -> dict:
        return {"kind": "file", "seed": self.seed}

    def restore(self, state: dict) -> None:
        assert state.get("kind") == "file"
