"""input_ms: host ms a request inside `multiscale._device_sequence` (the
packed window's copy to the card)."""

from portbench.metrics._spans import per_request_ms


def read(run: dict):
    return per_request_ms(run, "multiscale._device_sequence")
