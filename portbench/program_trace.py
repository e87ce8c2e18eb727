"""The program's own spans in one request's `torch.profiler` Chrome trace:
the launches inside each, and the device's idle time put down to them.

With `orca_tpu_torch.utils.profiling.enable(True)` under the profiler,
each span of the program (`orca.*`) is a `user_annotation` on the trace's
clock, the clock of the kernels and copies. Inside the request's window
(the `request` annotation, as `trace.py` reads it) this counts, per span
name, its calls, host time and the launch calls (`cudaLaunchKernel*`,
`cuLaunchKernel*`) that begin inside it, nested spans' included; and it
splits every idle stretch of the window (no kernel, copy or memset) at the
spans' boundaries, each piece going to the innermost span open over it,
`-` where none is. Where the trace holds no `orca.*` span, every idle
piece goes to `-` and `spans` is empty.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict

from portbench.trace import DEVICE_CATS, LAUNCH_CATS, WINDOW, merged

PREFIX = "orca."
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel")
NONE = "-"


def read(path: str) -> Dict:
    """One request's figures, times in seconds: `window_s`, `idle_s`,
    `launches` (all in the window), `spans` {name: {calls, host_s,
    launches, idle_s}} and `idle` {innermost span name or '-': s}."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e["name"] == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"trace: {len(win)} '{WINDOW}' windows")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]

    def clip(e):
        return max(e["ts"], w0), min(e["ts"] + e["dur"], w1)

    busy = merged(clip(e) for e in events if e.get("cat") in DEVICE_CATS
                  and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    launches = sorted(e["ts"] for e in events
                      if e.get("cat") in LAUNCH_CATS
                      and e["name"].startswith(LAUNCH_NAMES)
                      and w0 <= e["ts"] < w1)
    # outer before inner where two begin together
    spans = sorted(((*clip(e), e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIX)
                    and e["ts"] < w1 and e["ts"] + e["dur"] > w0),
                   key=lambda s: (s[0], -s[1]))

    by_name: Dict[str, dict] = {}
    for a, b, name in spans:
        s = by_name.setdefault(name, {"calls": 0, "host_s": 0.0,
                                      "launches": 0, "idle_s": 0.0})
        s["calls"] += 1
        s["host_s"] += (b - a) / 1e6
        s["launches"] += (bisect.bisect_left(launches, b)
                          - bisect.bisect_left(launches, a))

    # the idle stretches, cut at every span's start and end: a sweep that
    # keeps the spans open at the cursor (innermost: the latest begun)
    # (time, 0 opens / 1 closes, span): a span of no length opens first
    points = sorted([(a, 0, i) for i, (a, _, _) in enumerate(spans)]
                    + [(b, 1, i) for i, (_, b, _) in enumerate(spans)])
    out_idle: Dict[str, float] = {}
    open_now: set = set()
    p = 0

    def advance(t):
        nonlocal p
        while p < len(points) and points[p][0] <= t:
            _, kind, i = points[p]
            (open_now.discard if kind else open_now.add)(i)
            p += 1

    def put(a, b):
        if b <= a:
            return
        name = spans[max(open_now)][2] if open_now else NONE
        out_idle[name] = out_idle.get(name, 0.0) + (b - a) / 1e6
        if open_now:
            by_name[name]["idle_s"] += (b - a) / 1e6

    for a, b in idle:
        advance(a)
        cursor = a
        while p < len(points) and points[p][0] < b:
            put(cursor, points[p][0])
            cursor = points[p][0]
            advance(cursor)
        put(cursor, b)

    return {
        "window_s": (w1 - w0) / 1e6,
        "idle_s": sum(b - a for a, b in idle) / 1e6,
        "launches": len(launches),
        "spans": by_name,
        "idle": out_idle,
    }
