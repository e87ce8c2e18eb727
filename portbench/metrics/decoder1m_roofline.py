"""decoder1m_roofline: the least time of the standalone 1 Mb model's 2-D
stack, the pairwise map and Decoder_1m (portbench.flops1m: per layer the
larger of FLOPs over the precision's peak and bytes over 3.35 TB/s), over
the device time of the operations launched inside `onemb._decode_1m`, in
the profiled requests, in %. The stack's maps and crop a request come from
the FLOPs the driver counts, its rows a call from the span's calls."""

from portbench.flops1m import decoder1m_geometry, decoder1m_least_seconds
from portbench.metrics._spans import trace_span_total


def read(run: dict):
    device_s, calls = trace_span_total(run, "onemb._decode_1m", "device_s")
    if not calls or device_s <= 0:
        return None
    maps, crop = decoder1m_geometry(run["request_flops"])
    rows = maps * len(run["requests"]) // calls
    least = calls * decoder1m_least_seconds(rows, crop, run["precision"],
                                            run["peak_flops"])
    return 100.0 * least / device_s
