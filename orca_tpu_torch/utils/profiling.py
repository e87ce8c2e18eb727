"""Profiling hooks (counterpart of orca_tpu/utils/profiling.py).

Thin wrappers over torch.profiler: a Chrome trace of a block (the CPU, and
the CUDA card when there is one) and a wall-time timer that forces
completion before it reads the clock. Besides, the program's own spans and
counters: `span(name)` around a stretch of host work and `count(name, n)`
at a site, both no-ops until `enable(True)`. Enabled, they add to this
process's aggregates, which `take()` returns and resets, and each span also
lands in a running `torch.profiler` trace under its name, on the clock of
the kernels and copies. Neither ever waits for, or queues work on, a card.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from orca_tpu_torch.utils.tree import tree_leaves

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block: `with trace('/tmp/prof') as path: run()` writes a
    Chrome trace to `path` (logdir/trace.json), for chrome://tracing or
    Perfetto. The CPU is traced, and CUDA when it is available."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(logdir, TRACE_FILE)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


_clock = time.perf_counter_ns
_enabled = False
_lock = threading.Lock()
_local = threading.local()  # .open: this thread's open spans, innermost last
_spans: Dict[str, list] = {}  # name -> [host ns, calls, self ns]
_counters: Dict[str, int] = {}
_OFF = contextlib.nullcontext()  # every span while off


class _Span:
    """An open span of an enabled process."""

    __slots__ = ("name", "start", "inner", "region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.region = None
        if torch._C._autograd._profiler_enabled():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        stack.append(self)
        self.inner = 0
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self.start
        stack = _local.open
        stack.pop()
        if stack:
            stack[-1].inner += ns
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0, 0])
            agg[0] += ns
            agg[1] += 1
            agg[2] += ns - self.inner
        if self.region is not None:
            self.region.__exit__(*exc)
        return False


def enable(on: bool = True) -> bool:
    """Turn the program's spans and counters on or off for this process;
    returns the previous setting. Turning them on does not clear what an
    earlier `enable` gathered: `take()` does."""
    global _enabled
    previous, _enabled = _enabled, bool(on)
    return previous


def span(name: str, part: Optional[object] = None):
    """A stretch of host work named `name` (`name.part` when `part` is
    given): `with span('orca.tower'): ...`. Off, the one shared no-op.
    On, its host time (`perf_counter_ns`) and calls add to the name's
    aggregates, and to its `self_s` less the spans opened inside it on the
    same thread; under a running `torch.profiler` it is also a
    `record_function` region of the same name."""
    if not _enabled:
        return _OFF
    return _Span(name if part is None else f"{name}.{part}")


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` (nothing while off)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def take() -> dict:
    """What the spans and counters gathered since the last call, and reset
    them: {'spans': {name: {'host_s', 'calls', 'self_s'}}, 'counters':
    {name: n}}. A span still open is counted when it closes."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = {}, {}
    return {"spans": {name: {"host_s": v[0] / 1e9, "calls": v[1],
                             "self_s": v[2] / 1e9}
                      for name, v in spans.items()},
            "counters": counters}


def device_time(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Mean wall seconds per call of `fn(*args)`, after `warmup` calls, each
    call's output forced to completion."""
    for _ in range(warmup):
        _force(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _force(fn(*args))
    return (time.perf_counter() - t0) / iters


def _force(out):
    """Wait for `out`: synchronize the card when a leaf lies on CUDA, else
    read the first leaf."""
    leaves = tree_leaves(out)
    cuda = [t for t in leaves if isinstance(t, torch.Tensor) and t.is_cuda]
    if cuda:
        torch.cuda.synchronize(cuda[0].device)
    elif leaves and isinstance(leaves[0], torch.Tensor):
        float(leaves[0].float().sum())
    elif leaves:
        float(np.sum(np.asarray(leaves[0], dtype=np.float32)))
