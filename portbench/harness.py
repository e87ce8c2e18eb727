"""One run of one cell: set-up, warm-up, a closed-loop window of requests
from one client, the traced reading of the per-layer metrics, and the
comparison with the plain reference that decides `correct`.

Everything that belongs to one configuration, traffic mix, request kind or
per-layer metric sits in a file of its own that this module finds by name:
`configs/<config>.json`, `traffic/<mix>.json`, `drivers/<driver>.py`
(named by the mix's `driver`) and `metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import compare, trace
from portbench.flops import peak_flops

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orca_tpu")
GIB = 2 ** 30


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def quantity(name: str) -> str:
    """What a metric measures: its name before the first dot. A quantity
    split by the cells that report it (`mb_per_s.fp32`) is read as the
    quantity (`mb_per_s`)."""
    return name.split(".", 1)[0]


def _load_file(kind: str, name: str):
    """The module portbench/<kind>/<name>.py, loaded by path (a metric's
    name may hold dots); a metric with no reader of its own is read by its
    quantity's."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(manifest: dict, workload: str) -> dict:
    """The cell's manifest entry, configuration, traffic mix and the
    metrics it reports: {'cell', 'config', 'traffic', 'end_to_end',
    'per_layer'}."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = _load_json("configs", cell["config"])
    traffic = _load_json("traffic", cell["traffic"])

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


def load_driver(traffic: dict):
    return _load_file("drivers", traffic["driver"]).Driver


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`orca_tpu_torch` is not `orca_tpu`)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------------------
# Spans: the configuration names module-level functions of the program,
# which their callers look up at call time; a traced run wraps each in a
# labelled region and a host clock.
# --------------------------------------------------------------------------


def span_label(qualname: str) -> str:
    """'orca_tpu_torch.predict.multiscale._tower' -> 'multiscale._tower'."""
    module, fn = qualname.rsplit(".", 1)
    return f"{module.rsplit('.', 1)[-1]}.{fn}"


class SpanClock:
    """Host seconds and calls inside each wrapped span, since `reset`."""

    def __init__(self):
        self.figures: Dict[str, list] = {}

    def reset(self) -> Dict[str, dict]:
        out = {k: {"host_s": v[0], "calls": v[1]}
               for k, v in self.figures.items()}
        self.figures = {}
        return out

    def add(self, label: str, seconds: float) -> None:
        f = self.figures.setdefault(label, [0.0, 0])
        f[0] += seconds
        f[1] += 1


@contextlib.contextmanager
def wrapped_spans(qualnames, clock: SpanClock):
    installed = []
    try:
        for q in qualnames:
            module_name, fn_name = q.rsplit(".", 1)
            module = importlib.import_module(module_name)
            real = getattr(module, fn_name)
            label = span_label(q)

            def run(*args, _real=real, _label=label, **kwargs):
                t = time.perf_counter()
                try:
                    with torch.profiler.record_function(_label):
                        return _real(*args, **kwargs)
                finally:
                    clock.add(_label, time.perf_counter() - t)

            setattr(module, fn_name, run)
            installed.append((module, fn_name, real))
        yield
    finally:
        for module, fn_name, real in reversed(installed):
            setattr(module, fn_name, real)


def _traced_call(call: Callable, tmpdir: str, labels) -> tuple:
    """(output, latency s, trace figures) of one request under the
    profiler; the trace file is read and deleted."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        with torch.profiler.record_function(trace.WINDOW):
            out = call()
        latency = time.perf_counter() - t
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, "request.json")
    prof.export_chrome_trace(path)
    try:
        figures = trace.read(path, labels)
    finally:
        os.unlink(path)
    return out, latency, figures


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------


def _p90(values) -> float:
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _breakdown(figures: List[dict]) -> dict:
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for f in figures:
        for name, (_, s) in f["ops"].items():
            ops[name] = ops.get(name, 0.0) + s
        for name, (_, s) in f["gaps"].items():
            gaps[name] = gaps.get(name, 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda") -> dict:
    """One run; returns the result line's object. `t0` is the process's
    start on the monotonic clock (set-up is counted from it)."""
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    on_card = torch.device(device).type == "cuda"
    t_import = time.monotonic() - t0
    driver = load_driver(traffic)(config, traffic, seed, device)
    t_built = time.monotonic() - t0
    driver.warmup()
    log(f"set-up split: start and imports {t_import:.3f} s, inputs and "
        f"models {t_built - t_import:.3f} s, warm-up "
        f"{time.monotonic() - t0 - t_built:.3f} s")
    labels = [span_label(q) for q in config.get("spans", [])]
    clock = SpanClock()
    stack = contextlib.ExitStack()
    tmpdir = None
    every = traffic.get("trace_every", 1)
    if traced:
        stack.enter_context(wrapped_spans(config.get("spans", []), clock))
        tmpdir = stack.enter_context(tempfile.TemporaryDirectory(
            prefix="portbench_"))
        # the profiler's first start pays its own set-up
        _traced_call(lambda: driver.call(driver.request(-2)), tmpdir, labels)
    setup_s = time.monotonic() - t0
    log(f"set-up {setup_s:.3f} s")

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    done, records = [], []
    attempted = failed = 0
    spent = 0.0
    start = time.perf_counter()
    with stack:
        # a traced run's window counts request time alone: reading a
        # request's trace pauses the loop
        while (spent if traced else time.perf_counter() - start) < seconds:
            req = driver.request(attempted)
            profiled = traced and attempted % every == 0
            attempted += 1
            clock.reset()
            t = time.perf_counter()
            try:
                if profiled:
                    out, lat, fig = _traced_call(lambda: driver.call(req),
                                                 tmpdir, labels)
                else:
                    out = driver.call(req)
                    lat = time.perf_counter() - t
                    fig = None
            except Exception:  # a request that fails counts, and is logged
                failed += 1
                log(traceback.format_exc())
                spent += time.perf_counter() - t
                continue
            spent += lat
            records.append({"latency_s": lat, "spans": clock.reset(),
                            "trace": fig})
            done.append((req, driver.answer(out)))
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window {window_s:.3f} s, {len(done)} requests, {failed} failed")

    # the program's state goes before the reference runs
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(driver, done, seed, traffic)
    correct = failed == 0 and bool(done) and within(checks)

    mb = sum(driver.mb(req) for req, _ in done)
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if on_card:
        device_block = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"]}
    else:
        device_block = {"platform": "cpu", "kind": "cpu", "count": 1}
    device_block["memory_peak_bytes"] = int(peak)
    if not traced:
        values = {"setup_s": setup_s,
                  "mb_per_s": mb / window_s,
                  "request_s_p90": (_p90([r["latency_s"] for r in records])
                                    if records else compare.WORST),
                  "peak_device_gib": peak / GIB}
        metrics = {m["name"]: {"value": values[quantity(m["name"])],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    else:
        card = device_block["kind"]
        run = {
            "requests": [r for r in records if r["trace"] is not None],
            "untraced": [r for r in records if r["trace"] is None],
            "precision": traffic["precision"],
            # the work the request kind's model defines, counted by its
            # driver
            "request_flops": driver.request_flops(),
            "peak_flops": peak_flops(card, traffic["precision"]),
            "tower_least_s": driver.tower_least_s(card),
        }
        metrics = {}
        for m in spec["per_layer"]:
            value = _load_file("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        figures = [r["trace"] for r in run["requests"]]
        device_block["busy_s"] = sum(f["busy_s"] for f in figures)
        device_block["window_s"] = sum(f["window_s"] for f in figures)
        result["breakdown"] = _breakdown(figures)
    result["metrics"] = metrics
    result["device"] = device_block
    result["checks"] = checks
    return result


def within(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def check(driver, done, seed: int, traffic: dict,
          memo: Optional[dict] = None) -> Dict[str, dict]:
    """Compares a sample of the window's answers, drawn from the seed and
    holding the longest request (`driver.length`), with the plain
    reference (and, where the traffic mix names a `scale` precision, with
    the reference run in it too, the unit of its scaled numbers); each
    number with its limit (the traffic mix's `limits`). `memo` keeps the
    reference's answers by request index, for a second list of answers to
    the same requests."""
    limits = traffic["limits"]
    if not done:
        return {name: {"value": compare.WORST, "limit": lim}
                for name, lim in limits.items()}
    memo = {} if memo is None else memo
    rng = np.random.default_rng([seed, 7])
    size = min(traffic["check_requests"], len(done))
    longest = max(range(len(done)),
                  key=lambda i: (driver.length(done[i][0]), -i))
    rest = [i for i in range(len(done)) if i != longest]
    picked = [longest] + [int(i) for i in
                          rng.choice(rest, size - 1, replace=False)]
    numbers: Dict[str, float] = {}
    for i in sorted(picked):
        req, got = done[i]
        if i not in memo:
            t = time.perf_counter()
            memo[i] = (driver.reference(req, "fp32"),
                       driver.reference(req, traffic["scale"])
                       if "scale" in traffic else None)
            log(f"reference for request {i}: "
                f"{time.perf_counter() - t:.3f} s")
        want, scale = memo[i]
        for name, value in compare.numbers(got, want, scale).items():
            numbers[name] = max(numbers.get(name, 0.0), value)
    out = {name: {"value": numbers.get(name, compare.WORST), "limit": lim}
           for name, lim in limits.items()}
    for name, c in out.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return out
