"""The port's profiling hooks (orca_tpu_torch/utils/profiling.py) on the CPU:
`trace` writes a Chrome trace that parses as JSON and holds the regions
`annotate` labels, and `device_time` calls its function warmup + iters
times and returns a positive mean."""

import json
import os

import numpy as np
import torch

from orca_tpu_torch.utils import profiling


def test_trace_writes_annotated_chrome_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as path:
        with profiling.annotate("orca_region"):
            y = x @ x
    assert path == os.path.join(logdir, profiling.TRACE_FILE)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "orca_region"]
    assert spans and all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)
    assert torch.isfinite(y).all()


def test_trace_is_written_when_the_block_raises(tmp_path):
    logdir = str(tmp_path / "prof")
    try:
        with profiling.trace(logdir):
            with profiling.annotate("failing"):
                raise KeyError("inside the trace")
    except KeyError:
        pass
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        assert any(e.get("name") == "failing"
                   for e in json.load(f)["traceEvents"])


def test_device_time_counts_calls_and_returns_a_mean():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"out": [torch.mm(a, b)], "host": np.ones(3)}

    a = torch.randn(32, 32)
    secs = profiling.device_time(fn, a, a, iters=4, warmup=2)
    assert len(calls) == 6
    assert secs > 0


def test_device_time_forces_numpy_and_empty_outputs():
    calls = []

    def fn():
        calls.append(1)
        return [np.arange(4.0)] if len(calls) % 2 else ()

    assert profiling.device_time(fn, iters=3, warmup=1) > 0
    assert len(calls) == 4
