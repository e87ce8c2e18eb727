"""Helpers the per-layer metric readers share.

`run["untraced"]` holds the traced run's requests that ran without the
profiler, each with its `latency_s` and its wrapped spans' host clock
(`spans`: label -> {host_s, calls}); `run["requests"]` holds the profiled
ones, each also with its reduced `trace` (portbench.trace.read)."""


def timed_requests(run: dict):
    """The requests whose host clock the profiler did not slow, else the
    profiled ones."""
    return run["untraced"] or run["requests"]


def per_request_ms(run: dict, label_prefix: str):
    """Host ms a request inside the spans whose label starts with
    `label_prefix`, or None where none ran."""
    reqs = timed_requests(run)
    total, calls = 0.0, 0
    for r in reqs:
        for label, s in r["spans"].items():
            if label.startswith(label_prefix):
                total += s["host_s"]
                calls += s["calls"]
    if not calls:
        return None
    return 1e3 * total / len(reqs)


def trace_span_total(run: dict, label_prefix: str, field: str):
    """(sum of a traced span figure, calls) over the profiled requests."""
    total, calls = 0.0, 0
    for r in run["requests"]:
        for label, s in r["trace"]["spans"].items():
            if label.startswith(label_prefix):
                total += s[field]
                calls += s["calls"]
    return total, calls
