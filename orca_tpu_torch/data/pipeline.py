"""Parallel input pipeline: prefetching sampler workers (a copy of
orca_tpu/data/pipeline.py).

The reference trains through selene's `SamplerDataLoader` with up to 32
worker processes. `PrefetchLoader` plays that role for any sampler of this
package: workers draw batches on the host (memmap slices, cooler fetches,
adaptive coarse-graining) and push them into a bounded queue, so the card's
step never waits on sampling.

backend='process' forks worker processes (the default, as in the JAX
package: the data layer's lazy handles, MemmapGenome's mmap and
CoolerContactMatrix's cooler, re-open per process). The training process
has CUDA open when it forks: the samplers are numpy only, and a worker must
never touch torch.cuda (CUDA does not survive a fork).
backend='thread' uses threads (numpy and cooler release the GIL for the
heavy parts; useful where fork is unavailable, and in tests).
"""

from __future__ import annotations

import copy
import multiprocessing as mp
import queue as queue_mod
import threading
from typing import Optional


def _reseed(sampler, worker_id: int, seed: int) -> None:
    """Give each worker an independent random stream (after fork all
    workers would otherwise replay identical draws)."""
    import numpy as np

    if hasattr(sampler, "rng"):
        sampler.rng = np.random.default_rng(seed + 7919 * (worker_id + 1))


class WorkerError(Exception):
    """A sampler worker died; carries the worker's formatted traceback."""

    def __init__(self, worker_id: int, tb: str):
        super().__init__(
            f"PrefetchLoader worker {worker_id} died:\n{tb}"
        )
        self.worker_id = worker_id
        self.tb = tb


class _ErrorSentinel:
    """Queue marker for a worker exception (picklable across processes)."""

    def __init__(self, worker_id: int, tb: str):
        self.worker_id = worker_id
        self.tb = tb


def _worker_loop(sampler, batch_size, mode, out_queue, stop_event,
                 worker_id, seed):
    _reseed(sampler, worker_id, seed)
    try:
        while not stop_event.is_set():
            batch = sampler.sample(batch_size, mode=mode)
            while not stop_event.is_set():
                try:
                    out_queue.put(batch, timeout=0.25)
                    break
                except queue_mod.Full:
                    continue
    except Exception:  # noqa: BLE001 — any sampler error must surface
        import traceback

        # error sentinel: the consumer raises instead of hanging forever
        # on a dead worker pool (a cooler I/O hiccup days into a run)
        tb = traceback.format_exc()
        try:
            out_queue.put(_ErrorSentinel(worker_id, tb), timeout=5.0)
        except queue_mod.Full:
            pass


class PrefetchLoader:
    """Continuously prefetches `sampler.sample(batch_size, mode)` results.

    get() pops the next ready batch; close() stops the workers. Batch
    order is nondeterministic across workers (like the reference's
    SamplerDataLoader) — samplers are random-draw, so order carries no
    meaning.
    """

    def __init__(self, sampler, batch_size: int, mode: str = "train",
                 num_workers: int = 2, prefetch: Optional[int] = None,
                 backend: str = "process", seed: int = 0):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.backend = backend
        prefetch = prefetch or 2 * num_workers
        self._workers = []
        if backend == "process":
            ctx = mp.get_context("fork")
            self._queue = ctx.Queue(maxsize=prefetch)
            self._stop = ctx.Event()
            for w in range(num_workers):
                p = ctx.Process(
                    target=_worker_loop,
                    args=(sampler, batch_size, mode, self._queue, self._stop,
                          w, seed),
                    daemon=True,
                )
                p.start()
                self._workers.append(p)
        elif backend == "thread":
            self._queue = queue_mod.Queue(maxsize=prefetch)
            self._stop = threading.Event()
            for w in range(num_workers):
                # each thread needs its own rng stream; share the rest
                s = copy.copy(sampler)
                t = threading.Thread(
                    target=_worker_loop,
                    args=(s, batch_size, mode, self._queue, self._stop,
                          w, seed),
                    daemon=True,
                )
                t.start()
                self._workers.append(t)
        else:
            raise ValueError(f"unknown backend {backend!r}")

    def _live_workers(self) -> int:
        return sum(1 for w in self._workers if w.is_alive())

    def get(self, timeout: Optional[float] = None):
        """Next ready batch. Raises WorkerError if a worker died with an
        exception, RuntimeError if the whole pool is dead (no batch can
        ever arrive) or `timeout` elapses."""
        waited = 0.0
        poll = 1.0
        while True:
            step = poll if timeout is None else min(poll, timeout - waited)
            try:
                item = self._queue.get(timeout=max(step, 0.01))
            except queue_mod.Empty:
                waited += step
                if self._live_workers() == 0 and self._queue.empty():
                    raise RuntimeError(
                        "all PrefetchLoader workers are dead and the queue "
                        "is empty (a process-backend worker killed without "
                        "a traceback, e.g. OOM?)"
                    ) from None
                if timeout is not None and waited >= timeout:
                    raise TimeoutError(
                        f"no batch within {timeout}s "
                        f"({self._live_workers()} live workers)"
                    ) from None
                continue
            if isinstance(item, _ErrorSentinel):
                raise WorkerError(item.worker_id, item.tb)
            return item

    def __iter__(self):
        while True:
            yield self.get()

    def close(self) -> None:
        import time

        self._stop.set()
        # Drain WHILE workers are alive: a worker whose queue-feeder thread
        # is blocked writing a large batch into the (64KB) pipe cannot exit
        # until the parent reads it; and a worker terminated mid-write
        # leaves a truncated frame on which any later parent read blocks
        # forever (mp get_nowait is only no-wait for poll(), not for
        # recv_bytes of a partial message). So: consume until the pool
        # exits on its own, then terminate stragglers and NEVER read again.
        deadline = time.time() + 10.0
        while (time.time() < deadline
               and any(w.is_alive() for w in self._workers)):
            try:
                self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                pass
        for w in self._workers:
            w.join(timeout=1.0)
            if not isinstance(w, threading.Thread) and w.is_alive():
                w.terminate()
        if self.backend == "process":
            self._queue.close()
        else:
            try:
                while True:
                    self._queue.get_nowait()
            except queue_mod.Empty:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
