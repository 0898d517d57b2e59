"""Continuous-batching front end for a live search engine.

Counterpart of :mod:`repro.serve.frontend`.  Serving traffic arrives one
query at a time, but every layer below — the CUDA kernel's query tile of
128, the τ prescan, the host's launches — is built for batches: a [1, d]
search wastes the query-tile axis and pays every launch per request.
:class:`ContinuousBatcher` closes the gap with the standard
continuous-batching loop: concurrent :meth:`submit` calls land in a
queue, a single worker coalesces them into microbatches bounded by ``max_batch`` (amortization ceiling) and
``max_wait_ms`` (latency floor), runs **one** engine search per
microbatch, and resolves each caller's future with its own row of the
result.

A microbatch is searched as the rows that coalesced, not padded.  The
reference zero-pads every microbatch to ``max_batch`` because its
dispatch cache keys on the shape; the port has no such cache, and the
kernel fills a partial query tile itself.  A zero row would cost more
than its compute: its top-k scores are all 0, so no tile bound falls
below its τ, and its query tile skips no tile.

The engine itself is not thread-safe against concurrent mutation, so the
worker serializes all device work through a single executor thread;
online inserts/deletes (:meth:`SearchEngine.online`) interleave safely
*between* microbatches by going through :meth:`run`, the same
single-thread funnel.
"""
from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["ContinuousBatcher"]


class ContinuousBatcher:
    """Coalesce concurrent single-query searches into engine microbatches.

    Args:
      engine: a :class:`repro_torch.search.SearchEngine` (any backend).
      k: top-k depth every submitted query is answered with.
      max_batch: the most queries one microbatch holds.
      max_wait_ms: how long the worker holds an underfull microbatch open
        for stragglers after the first query arrives.

    Use as an async context manager, or call :meth:`close` explicitly.
    """

    def __init__(self, engine, k: int, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        #: microbatches dispatched / queries served (occupancy telemetry)
        self.n_batches = 0
        self.n_queries = 0
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._worker: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closed = False

    # ------------------------------------------------------------- metrics
    @property
    def occupancy(self) -> float:
        """Mean fill of the dispatched microbatches: queries served over
        ``n_batches * max_batch`` (1.0 = every batch full)."""
        if self.n_batches == 0:
            return 0.0
        return self.n_queries / (self.n_batches * self.max_batch)

    # ----------------------------------------------------------- lifecycle
    async def __aenter__(self) -> "ContinuousBatcher":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Stop the worker after the queue drains; reject new submits."""
        if self._closed:
            return
        self._closed = True
        if self._worker is not None:
            if self._loop is asyncio.get_running_loop():
                await self._queue.join()
                self._worker.cancel()
                try:
                    await self._worker
                except asyncio.CancelledError:
                    pass
            # else: the worker's loop already died (sequential asyncio.run
            # reuse) and took the task with it — nothing left to drain
            self._worker = None
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------- serving
    async def submit(self, query):
        """Search one query ``[d]`` (numpy, or a tensor on any device, which
        stays there); returns ``(sims [k], ids [k])`` as numpy arrays once
        its microbatch has run."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        q = (query.detach().float() if isinstance(query, torch.Tensor)
             else np.asarray(query, np.float32))
        if q.ndim != 1:
            raise ValueError(f"submit takes one query [d], got {q.shape}")
        loop = asyncio.get_running_loop()
        if self._worker is not None and self._loop is not loop:
            # the worker belongs to another event loop.  If that loop is
            # still running this is genuine cross-loop use — refuse loudly.
            # Otherwise the loop died (the common sequential-asyncio.run
            # reuse): the old worker task and its queue are dead, and a
            # submit enqueued onto them would hang forever — re-create
            # both on the caller's loop (the executor thread is
            # loop-agnostic and keeps the engine serialized throughout).
            if self._loop is not None and self._loop.is_running():
                raise RuntimeError(
                    "batcher is already serving another running event "
                    "loop; one ContinuousBatcher binds to one loop at a "
                    "time")
            self._worker = None
            self._queue = asyncio.Queue()
        if self._worker is None:
            self._loop = loop
            self._worker = loop.create_task(self._run_worker())
        fut = loop.create_future()
        self._queue.put_nowait((q, fut))
        return await fut

    async def run(self, fn, *args):
        """Run ``fn(*args)`` on the batcher's device thread, serialized
        against search dispatches — the safe slot for online mutations
        (``engine.online().insert(...)``) while traffic is live."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, fn, *args)

    # -------------------------------------------------------------- worker
    async def _run_worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            batch = [first]
            deadline = loop.time() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0 and self._queue.empty():
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), max(timeout, 0.0)))
                except asyncio.TimeoutError:
                    break
            b = len(batch)
            q = _stack([qi for qi, _ in batch])
            try:
                sims, ids, _stats = await loop.run_in_executor(
                    self._pool, self._search, q)
                self.n_batches += 1
                self.n_queries += b
                for i, (_, fut) in enumerate(batch):
                    if not fut.done():
                        fut.set_result((sims[i], ids[i]))
            except Exception as e:                    # noqa: BLE001
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                for _ in batch:
                    self._queue.task_done()

    def _search(self, q):
        """One engine search of the microbatch; its rows come back to the
        host once, here (one device sync per microbatch)."""
        sims, ids, stats = self.engine.search(q, self.k)
        return sims.cpu().numpy(), ids.cpu().numpy(), stats


def _stack(queries):
    """One microbatch ``[b, d]`` of submitted rows: numpy if every row is,
    else a tensor on the first tensor row's device (numpy rows join it)."""
    dev = next((q.device for q in queries if isinstance(q, torch.Tensor)), None)
    if dev is None:
        return np.stack(queries)
    return torch.stack([torch.as_tensor(q, device=dev) for q in queries])
