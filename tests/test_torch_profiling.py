"""The port's profiling hooks (orca_tpu_torch/utils/profiling.py) on the CPU:
`trace` writes a Chrome trace that parses as JSON and holds the regions
`span` labels, `device_time` calls its function warmup + iters times and
returns a positive mean, and the program's spans and counters gather
nothing while off and the right calls, host and self time while on."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from orca_tpu_torch.utils import profiling


@pytest.fixture
def spans_on():
    """The spans and counters on for one test, emptied before and after."""
    previous = profiling.enable(True)
    profiling.take()
    yield
    profiling.enable(previous)
    profiling.take()


class FakeClock:
    """perf_counter_ns stand-in: each reading advances by `step` ns."""

    def __init__(self, step):
        self.now, self.step = 0, step

    def __call__(self):
        self.now += self.step
        return self.now


def test_trace_writes_annotated_chrome_trace(tmp_path, spans_on):
    logdir = str(tmp_path / "prof")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as path:
        with profiling.span("orca_region"):
            y = x @ x
    assert path == os.path.join(logdir, profiling.TRACE_FILE)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "orca_region"]
    assert spans and all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)
    assert torch.isfinite(y).all()


def test_trace_is_written_when_the_block_raises(tmp_path, spans_on):
    logdir = str(tmp_path / "prof")
    try:
        with profiling.trace(logdir):
            with profiling.span("failing"):
                raise KeyError("inside the trace")
    except KeyError:
        pass
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        assert any(e.get("name") == "failing"
                   for e in json.load(f)["traceEvents"])
    assert profiling.take()["spans"]["failing"]["calls"] == 1


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


def test_off_gathers_nothing_and_opens_no_region(monkeypatch, tmp_path):
    """Off (the default): one shared no-op, no clock reading, no
    record_function, even under a running profiler."""
    assert profiling.enable(False) is False
    profiling.take()

    def refuse(*args, **kwargs):
        raise AssertionError("called while off")

    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.trace(str(tmp_path)):
        with profiling.span("orca.a"):
            with profiling.span("orca.b", 3):
                profiling.count("h2d_bytes", 10)
    assert profiling.span("orca.a") is profiling.span("orca.b", 3)
    assert profiling.take() == {"spans": {}, "counters": {}}


def test_nested_spans_give_calls_host_and_self_time(monkeypatch, spans_on):
    monkeypatch.setattr(profiling, "_clock", FakeClock(1000))
    with profiling.span("orca.outer"):  # reads 1000
        for _ in range(2):
            with profiling.span("orca.inner", 8):  # 2000 .. 3000
                pass
        with profiling.span("orca.sync"):  # 6000 .. 7000
            pass
    # outer ends at 8000
    got = profiling.take()["spans"]
    assert got == {
        "orca.outer": {"host_s": 7e-6, "calls": 1, "self_s": 4e-6},
        "orca.inner.8": {"host_s": 2e-6, "calls": 2, "self_s": 2e-6},
        "orca.sync": {"host_s": 1e-6, "calls": 1, "self_s": 1e-6},
    }


def test_counters_add_and_take_resets(spans_on):
    profiling.count("h2d_bytes", 128)
    profiling.count("h2d_bytes", np.int64(72))
    profiling.count("other", 1)
    with profiling.span("orca.x"):
        pass
    first = profiling.take()
    assert first["counters"] == {"h2d_bytes": 200, "other": 1}
    assert first["spans"]["orca.x"]["calls"] == 1
    assert first["spans"]["orca.x"]["host_s"] >= 0
    assert profiling.take() == {"spans": {}, "counters": {}}


def test_enable_returns_the_previous_setting():
    previous = profiling.enable(True)
    try:
        assert profiling.enable(True) is True
        assert profiling.enable(False) is True
        assert profiling.enable(False) is False
    finally:
        profiling.enable(previous)
        profiling.take()


def test_threads_keep_their_own_nesting(spans_on):
    """A span open on one thread is not the parent of another thread's:
    self time is taken from the same thread's children only."""
    inside, release = threading.Event(), threading.Event()

    def worker():
        with profiling.span("orca.worker"):
            inside.set()
            release.wait(10)

    t = threading.Thread(target=worker)
    with profiling.span("orca.main"):
        t.start()
        assert inside.wait(10)
        with profiling.span("orca.main_child"):
            pass
        release.set()
        t.join(10)
    assert not t.is_alive()
    got = profiling.take()["spans"]
    assert got["orca.worker"]["self_s"] == got["orca.worker"]["host_s"]
    assert got["orca.main"]["self_s"] == pytest.approx(
        got["orca.main"]["host_s"] - got["orca.main_child"]["host_s"])


def test_spans_land_in_the_chrome_trace_by_name_and_count(tmp_path,
                                                           spans_on):
    x = torch.randn(16, 16)
    with profiling.trace(str(tmp_path)) as path:
        for level in (32, 16):
            with profiling.span("orca.decode", level):
                for _ in range(3):
                    with profiling.span("orca.sync"):
                        x = x @ x / 16
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in events]
    assert names.count("orca.decode.32") == 1
    assert names.count("orca.decode.16") == 1
    assert names.count("orca.sync") == 6
    took = profiling.take()["spans"]
    assert {n: s["calls"] for n, s in took.items()} == {
        "orca.decode.32": 1, "orca.decode.16": 1, "orca.sync": 6}
