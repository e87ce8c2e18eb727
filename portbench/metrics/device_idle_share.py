"""device_idle_share: the share of the profiled requests' time in which no
kernel, copy or memset ran on the card, in %."""


def read(run: dict):
    window = sum(r["trace"]["window_s"] for r in run["requests"])
    if window <= 0:
        return None
    busy = sum(r["trace"]["busy_s"] for r in run["requests"])
    return 100.0 * (1.0 - busy / window)
