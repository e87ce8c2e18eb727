"""Model weights drawn from the run's seed, as statedicts in the released
Orca key layout (`module.`-prefixed, one dict a file, BatchNorm with its
running statistics), made on the device in one draw a model.

Convolutions take torch's default init, U(-l, l) with l = 1/sqrt(fan_in),
for weight and bias; BatchNorm scale U(0.9, 1.1), shift and running mean
U(-0.05, 0.05), running variance U(0.8, 1.2). The same seed gives the same
bits on the same device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.orca import statedict_shapes


def child_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of the run (a model, the pool, the
    draws of requests), from the run's seed and the stream's path."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def _fan_in(shape) -> int:
    return int(np.prod(shape[1:]))


def draw_statedicts(family: str, levels, seed: int,
                    device) -> Dict[str, Dict[str, torch.Tensor]]:
    """file -> statedict of one model (`reference.orca.model_files`), drawn
    on `device` from `seed`."""
    shapes = statedict_shapes(family, levels)
    sizes = [math.prod(s) for f in shapes.values() for k, s in f.items()
             if not k.endswith("num_batches_tracked")]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, pos = {}, 0
    for name, keys in shapes.items():
        sd = {}
        for key, shape in keys.items():
            if key.endswith("num_batches_tracked"):
                sd["module." + key] = torch.tensor(0, dtype=torch.long,
                                                   device=device)
                continue
            n = math.prod(shape)
            x = u[pos:pos + n].reshape(shape)
            pos += n
            prefix, leaf = key.rsplit(".", 1)
            if f"{prefix}.running_mean" in keys:  # BatchNorm
                lo, hi = {"weight": (0.9, 1.1), "running_var": (0.8, 1.2)}.get(
                    leaf, (-0.05, 0.05))
            else:
                lim = 1.0 / math.sqrt(_fan_in(keys[f"{prefix}.weight"]))
                lo, hi = -lim, lim
            sd["module." + key] = x * (hi - lo) + lo
        out[name] = sd
    return out
