"""256 Mb whole-chromosome cascade throughput on the CUDA card (counterpart
of the JAX package's scripts/bench_256m.py).

Measures the full 4-level 256 Mb multiscale prediction (fwd+RC, the region
mosaic's background, three-tower encoder stack) of a random folded bundle
on a chr8-sized chromosome padded to 256 Mb, and prints one JSON line with
the JAX script's keys plus `power_limit_w`. The timed window is
`orca_tpu_torch.bench._measure_256m`'s, the one `bench` times: the packed
sequence already on the card, each run ended by a host fetch of the last
level's sum. `compile_s` is the warm-up request plus one run (torch
compiles nothing; the kernels' nvcc build is in it when none is cached).
ORCA_BENCH_DTYPE (default bfloat16) and ORCA_BENCH_ITERS (default 3) as in
the JAX script. Numbers are not rounded.

    python -m orca_tpu_torch.scripts.bench_256m
"""

from __future__ import annotations

import json
import os

import torch

from orca_tpu_torch.bench import _measure_256m
from orca_tpu_torch.predict.multiscale import GEOM_256M, CascadeGeometry
from orca_tpu_torch.scripts._common import card_fields
from orca_tpu_torch.utils.config import resolve_device


def main(geometry: CascadeGeometry = GEOM_256M, device=None) -> dict:
    """Time the window and print the JSON line; returns it. The geometry
    and `device` (None = the CUDA card) are production; tests run them
    small on the CPU."""
    device = resolve_device(device)
    dtype = os.environ.get("ORCA_BENCH_DTYPE", "bfloat16")
    iters = int(os.environ.get("ORCA_BENCH_ITERS", "3"))
    torch.zeros(1, device=device).cpu()  # CUDA context and the first fetch
    dt, compile_s = _measure_256m(dtype, iters, geometry, device)
    card = card_fields(device)
    line = {
        "metric": "Mb_sequence_per_s_per_chip_256Mb_multiscale",
        "value": geometry.window_bp / 1e6 / dt,
        "unit": "Mb/s/chip",
        "seconds_per_256Mb_window": dt,
        "compile_s": compile_s,
        "device": card["device"],
        "power_limit_w": card["power_limit_w"],
        "dtype": dtype,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
