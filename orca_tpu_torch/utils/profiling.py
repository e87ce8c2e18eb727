"""Profiling hooks (counterpart of orca_tpu/utils/profiling.py).

Thin wrappers over torch.profiler: a Chrome trace of a block (the CPU, and
the CUDA card when there is one), labelled regions inside it, and a
wall-time timer that forces completion before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time

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


def annotate(name: str):
    """A labelled region inside a trace (`with annotate('request'): ...`)."""
    return torch.profiler.record_function(name)


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
