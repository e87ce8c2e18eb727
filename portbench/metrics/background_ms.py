"""background_ms: host ms a request inside `multiscale._filled_background`
(the 256 Mb background's float32 copy and NaN fill)."""

from portbench.metrics._spans import per_request_ms


def read(run: dict):
    return per_request_ms(run, "multiscale._filled_background")
