"""tower_roofline: the encoder tower's least time (portbench.flops: per
stage the larger of FLOPs over the peak and bytes over the memory
bandwidth) over the device time of the operations launched inside
`multiscale._tower`, in the profiled requests, in %."""

from portbench.metrics._spans import trace_span_total


def read(run: dict):
    device_s, calls = trace_span_total(run, "multiscale._tower", "device_s")
    if not calls or device_s <= 0:
        return None
    return 100.0 * run["tower_least_s"] * len(run["requests"]) / device_s
