"""Reduction of one request's `torch.profiler` Chrome trace (the arithmetic
of `chip_smoke.py`'s `read_trace`, kept here with the benchmark).

The request's window is its `request` annotation. Device time is the union
of kernel, memcpy and memset intervals inside it; an idle gap is a stretch
of the window with none, named by the innermost host operation active when
it began and the benchmark's span around it. A span's device time is the
summed duration of the device operations whose launch (matched by the
trace's correlation id) lies inside that span.
"""

from __future__ import annotations

import heapq
import json
from typing import Dict, Iterable, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "request"


def merged(intervals: Iterable) -> List[list]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def read(path: str, spans: Iterable[str]) -> Dict:
    """One request's figures, times in seconds: `window_s`, `busy_s`,
    `ops` {device op name: [count, s]}, `gaps` {label: [count, s]}, and per
    span name in `spans` its `host_s` (merged annotation time) and
    `device_s` (device operations launched inside it)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e["name"] == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"trace: {len(win)} '{WINDOW}' windows")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = merged((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in dev)
    ops: Dict[str, list] = {}
    for e in dev:
        o = ops.setdefault(e["name"][:120], [0, 0.0])
        o[0] += 1
        o[1] += e["dur"] / 1e6
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e["name"] != WINDOW), key=lambda e: e["ts"])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps: Dict[str, list] = {}
    active: list = []  # heap of (end, index) of host events begun so far
    j = 0
    for i in range(0, len(edges), 2):
        start, dur = edges[i], edges[i + 1] - edges[i]
        if dur <= 0:
            continue
        while j < len(host) and host[j]["ts"] <= start:
            heapq.heappush(active, (host[j]["ts"] + host[j]["dur"], j))
            j += 1
        while active and active[0][0] <= start:
            heapq.heappop(active)
        now = [host[k] for _, k in active]
        inner = min(now, key=lambda e: e["dur"])["name"] if now else "-"
        outer = [e["name"] for e in sorted(now, key=lambda e: -e["dur"])
                 if e.get("cat") == "user_annotation"]
        label = (f"{outer[0]} > {inner}" if outer and outer[0] != inner
                 else inner)[:120]
        g = gaps.setdefault(label, [0, 0.0])
        g[0] += 1
        g[1] += dur / 1e6
    by_span = {}
    launches = [e for e in host if e.get("cat") in LAUNCH_CATS
                and _corr(e) is not None]
    dev_by_corr: Dict[int, float] = {}
    for e in dev:
        c = _corr(e)
        if c is not None:
            dev_by_corr[c] = dev_by_corr.get(c, 0.0) + e["dur"]
    for name in spans:
        sp = merged((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e["name"] == name and e.get("cat") == "user_annotation")
        corrs = {_corr(e) for e in launches
                 if any(a <= e["ts"] < b for a, b in sp)}
        by_span[name] = {
            "calls": len(sp),
            "host_s": sum(b - a for a, b in sp) / 1e6,
            "device_s": sum(dev_by_corr.get(c, 0.0) for c in corrs) / 1e6,
        }
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": len(dev),
        "ops": ops,
        "gaps": gaps,
        "spans": by_span,
    }
