"""mfu: the FLOPs the model defines for a request (portbench.flops: tower,
pyramid(s), decoder levels and the 1 Mb head, forward and reverse
complement) over the request's seconds times the precision's peak, in %,
over the traced run's requests that ran without the profiler."""

from portbench.metrics._spans import timed_requests


def read(run: dict):
    reqs = timed_requests(run)
    seconds = sum(r["latency_s"] for r in reqs)
    if not reqs or seconds <= 0:
        return None
    flops = sum(run["request_flops"].values()) * len(reqs)
    return 100.0 * flops / (seconds * run["peak_flops"])
