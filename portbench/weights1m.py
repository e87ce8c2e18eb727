"""The standalone 1 Mb model's weights drawn from the run's seed, as the
released `Net` statedict (`module.`-prefixed): the `net0` keys through
`weights.draw_statedicts`, and the track head's `final_1d.*` keys from a
child seed under the same init (`weights.py`: torch's default conv init,
BatchNorm near identity), drawn on the device in one call.

`calibrate_track_head` then sets the track head's BatchNorm running
statistics to those of the activations it sees on a window, as training
leaves them. Drawn near identity they leave its hidden layer at a few
thousandths of its unit scale on the random tower's output: every track is
then 0.5 to within 1e-3 along the window, below bfloat16's spacing there,
and no comparison could tell a track from its neighbour's or its reverse
complement's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import orca, orca1m
from portbench.weights import child_seed, draw_statedicts


def _draw_final_1d(num_1d: int, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """The `final_1d.*` keys, drawn as `weights.draw_statedicts` draws a
    file (whose shapes come from `reference/orca.py`'s models alone)."""
    keys = {k: s for k, s in orca1m.statedict_shapes(num_1d).items()
            if k.startswith("final_1d.")}
    sizes = [math.prod(s) for k, s in keys.items()
             if not k.endswith("num_batches_tracked")]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    sd, pos = {}, 0
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
            fan_in = math.prod(keys[f"{prefix}.weight"][1:])
            lo, hi = -1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in)
        sd["module." + key] = x * (hi - lo) + lo
    return sd


def draw_net_statedict(num_1d: int, seed: int,
                       device) -> Dict[str, torch.Tensor]:
    """One 1 Mb model's `Net` statedict, drawn on `device` from `seed`."""
    sd = draw_statedicts("32m", (), child_seed(seed, 0), device)["net0"]
    sd.update(_draw_final_1d(num_1d, child_seed(seed, 1), device))
    return sd


@torch.no_grad()
def calibrate_track_head(sd: Dict[str, torch.Tensor], num_1d: int,
                         window: torch.Tensor) -> None:
    """Set `final_1d`'s BatchNorm running mean and variance in `sd` (in
    place) to the per-channel mean and variance of its first convolution's
    output over `window`, (1, L, 4) packed uint8 on `sd`'s device: the
    reference's float32 tower (TF32 off), one piece."""
    model = orca1m.load(sd, num_1d, window.device)
    conv = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    x = window.float().mul_(0.25).transpose(1, 2).contiguous()
    fwd = orca.Forward("fp32")
    with orca._tf32(False):
        h = torch.nn.functional.conv1d(fwd.tower(model, x),
                                       conv["final_1d.0.weight"],
                                       conv["final_1d.0.bias"])
    sd["module.final_1d.1.running_mean"] = h.mean(dim=(0, 2))
    sd["module.final_1d.1.running_var"] = h.var(dim=(0, 2))
