"""decode_ms: host ms a request inside the decoder levels
(`multiscale._decode_level`, `multiscale._decode_level_256`); each level
ends in a host fetch of its zoom starts, so the span holds its device
time."""

from portbench.metrics._spans import per_request_ms


def read(run: dict):
    return per_request_ms(run, "multiscale._decode_level")
