"""`program_trace.read` on a small synthetic Chrome trace against counts
made by hand: the launches inside each of the program's spans, and the
device's idle time split at the spans' boundaries, each piece put down to
the innermost span open over it. `trace.read` on the same trace gives the
dict pinned here, as it did before the program had spans."""

import json

import pytest

from portbench import program_trace, trace

US = 1e-6


def x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def synthetic(with_spans=True):
    """A 1000 us request: an input copy, the tower, two decoder levels each
    with a host wait inside, and 50 us of no span at the end.

        spans    input_copy 0-100, tower 100-400, decode.32 400-700 (sync
                 450-600), decode.16 700-950 (sync 900-940)
        device   memcpy 20-80, kernels 120-500, 520-560, 620-650, 720-800
        launches 110, 130 (tower); 410, 460 (in its sync), 610
                 (decode.32); 710, 720 (decode.16, the second through the
                 driver); 960 (no span); cudaMemcpyAsync at 10 and
                 cudaStreamSynchronize at 905 are no launches
    """
    ev = [x("request", "user_annotation", 0, 1000),
          x("aten::copy_", "cpu_op", 5, 90),
          x("cudaMemcpyAsync", "cuda_runtime", 10, 70, correlation=1),
          x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 60,
            correlation=1)]
    if with_spans:
        ev += [x("orca.input_copy", "user_annotation", 0, 100),
               x("orca.tower", "user_annotation", 100, 300),
               x("orca.decode.32", "user_annotation", 400, 300),
               x("orca.sync", "user_annotation", 450, 150),
               x("orca.decode.16", "user_annotation", 700, 250),
               x("orca.sync", "user_annotation", 900, 40)]
    for c, (ts, name, cat) in enumerate(
            [(110, "cudaLaunchKernel", "cuda_runtime"),
             (130, "cudaLaunchKernel", "cuda_runtime"),
             (410, "cudaLaunchKernel", "cuda_runtime"),
             (460, "cudaLaunchKernel", "cuda_runtime"),
             (610, "cudaLaunchKernel", "cuda_runtime"),
             (710, "cudaLaunchKernel", "cuda_runtime"),
             (720, "cuLaunchKernel", "cuda_driver"),
             (960, "cudaLaunchKernelExC", "cuda_runtime")], start=10):
        ev.append(x(name, cat, ts, 5, correlation=c))
    ev += [x("fused_conv_chain", "kernel", 120, 380, correlation=10),
           x("elementwise_add", "kernel", 520, 40, correlation=12),
           x("conv2d", "kernel", 620, 30, correlation=14),
           x("conv2d", "kernel", 720, 80, correlation=16),
           x("cudaStreamSynchronize", "cuda_runtime", 905, 30,
             correlation=99)]
    return {"traceEvents": ev}


def write(tmp_path, doc):
    path = tmp_path / "request.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_launches_and_idle_by_span_by_hand(tmp_path):
    got = program_trace.read(write(tmp_path, synthetic()))
    assert got["window_s"] == pytest.approx(1000 * US)
    # busy 60 + 380 + 40 + 30 + 80 us
    assert got["idle_s"] == pytest.approx(410 * US)
    assert got["launches"] == 8
    want = {  # name: (calls, host us, launches, idle us)
        "orca.input_copy": (1, 100, 0, 20 + 20),
        "orca.tower": (1, 300, 2, 20),
        "orca.decode.32": (1, 300, 3, 20 + 50),
        "orca.sync": (2, 190, 1, 20 + 40 + 40),
        "orca.decode.16": (1, 250, 2, 20 + 100 + 10),
    }
    assert set(got["spans"]) == set(want)
    for name, (calls, host, launches, idle) in want.items():
        s = got["spans"][name]
        assert s["calls"] == calls, name
        assert s["host_s"] == pytest.approx(host * US), name
        assert s["launches"] == launches, name
        assert s["idle_s"] == pytest.approx(idle * US), name
    assert got["idle"][program_trace.NONE] == pytest.approx(50 * US)
    assert {k: v for k, v in got["idle"].items()
            if k != program_trace.NONE} == {
        k: pytest.approx(w[3] * US) for k, w in want.items()}
    assert sum(got["idle"].values()) == pytest.approx(got["idle_s"])


def test_no_spans_put_every_idle_piece_down_to_none(tmp_path):
    got = program_trace.read(write(tmp_path, synthetic(with_spans=False)))
    assert got["spans"] == {}
    assert got["idle"] == {program_trace.NONE: pytest.approx(410 * US)}
    assert got["launches"] == 8


def test_spans_outside_the_window_and_empty_spans(tmp_path):
    doc = synthetic()
    doc["traceEvents"] += [
        x("orca.tower", "user_annotation", 1200, 100),  # after the window
        x("orca.sync", "user_annotation", 970, 0),  # no length
        x("orca.other", "user_annotation", 980, 40),  # clipped at 1000
        x("not_the_program", "user_annotation", 955, 10)]
    got = program_trace.read(write(tmp_path, doc))
    assert got["spans"]["orca.tower"]["calls"] == 1
    assert got["spans"]["orca.sync"]["calls"] == 3
    assert got["spans"]["orca.other"]["host_s"] == pytest.approx(20 * US)
    assert got["spans"]["orca.other"]["idle_s"] == pytest.approx(20 * US)
    assert got["idle"][program_trace.NONE] == pytest.approx(30 * US)
    assert "not_the_program" not in got["idle"]


def test_a_trace_without_one_window_fails(tmp_path):
    doc = synthetic()
    doc["traceEvents"].append(x("request", "user_annotation", 0, 10))
    with pytest.raises(RuntimeError, match="2 'request' windows"):
        program_trace.read(write(tmp_path, doc))


def test_trace_read_is_unchanged_by_the_program_spans(tmp_path):
    """The benchmark's own reduction of the same trace, pinned: the gaps
    are named at their first instant by the innermost host event and the
    longest annotation around it, spans by the labels asked for."""
    got = trace.read(write(tmp_path, synthetic()), ["orca.tower",
                                                    "orca.decode.32"])
    assert got == {
        "window_s": 0.001,
        "busy_s": 0.00059,
        "device_ops": 5,
        "ops": {"Memcpy HtoD (Pageable -> Device)": [1, 6e-05],
                "fused_conv_chain": [1, 0.00038],
                "elementwise_add": [1, 4e-05],
                "conv2d": [2, 0.00011]},
        # 80-120 us is one gap, named whole by what was active at 80
        "gaps": {"orca.input_copy": [1, 2e-05],
                 "orca.input_copy > aten::copy_": [1, 4e-05],
                 "orca.decode.32 > orca.sync": [2, 8e-05],
                 "orca.decode.32": [1, 7e-05],
                 "orca.decode.16": [1, 0.0002]},
        "spans": {"orca.tower": {"calls": 1, "host_s": 0.0003,
                                 "device_s": 0.00038},
                  "orca.decode.32": {"calls": 1, "host_s": 0.0003,
                                     "device_s": 7e-05}},
    }
