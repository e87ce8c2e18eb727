"""The plain reference of Orca's standalone 1 Mb models (`H1esc_1M`,
`Hff_1M`: jzhoulab/orca `orca_models.py`, their `Net`: `orca_modules.py`)
over a batch of 1 Mb windows, in plain PyTorch.

The model is `reference/orca.py`'s `Net0` (the bp -> 4 kb tower and
`Decoder_1m`) with Orca's 1-D track head `final_1d` (Conv1d 128 -> 128,
BatchNorm, ReLU, Conv1d 128 -> num_1d, sigmoid) on the tower's output; its
statedict, the released `Net` file, is the `net0` keys and the `final_1d.*`
keys. A window's forward: the tower over the whole window, the pairwise sum
of its output, `Decoder_1m`, symmetrisation, and the track head; with the
reverse complement, each window's output is averaged with its reverse
complement's, the map flipped on both axes and the tracks on positions.
Precisions are `reference/orca.py`'s (`Forward`): "fp32" float32 with TF32
off, "tf32", "fp8" and "bf16" roundings of every convolution's input and
weight.

Departures from `orca_modules.py`:

  * BatchNorm is folded into the convolution before it, in float64
    (`orca._fold`); eval mode, so dropout is the identity;
  * the input is the packed quarter-scale uint8 one-hot the benchmark
    hands the program (4 on the base's channel, 1 on all four at an N),
    expanded to float32 x 0.25: Orca's float one-hot, with 0.25 at an N;
  * the reverse-complement average is the serving path's (the JAX
    package's `predict_1m`), not part of Orca's module;
  * windows run one at a time (with their reverse complements), so that a
    64-row batch fits the card in float32.

This file imports nothing of the program.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch
from torch import nn

from portbench.reference.orca import Forward, Net0, _fold


def final_1d(num_1d: int) -> nn.Sequential:
    """Orca's `Net.final_1d`."""
    return nn.Sequential(nn.Conv1d(128, 128, 1), nn.BatchNorm1d(128),
                         nn.ReLU(), nn.Conv1d(128, num_1d, 1), nn.Sigmoid())


class Net(Net0):
    """The released 1 Mb `Net`: `Net0` and the track head."""

    def __init__(self, num_1d: int):
        super().__init__()
        self.final_1d = final_1d(num_1d)


def statedict_shapes(num_1d: int) -> Dict[str, tuple]:
    """key -> shape of the `Net` statedict (keys without 'module.')."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in Net(num_1d).state_dict().items()}


def load(statedict: Dict[str, torch.Tensor], num_1d: int, device):
    """The model on `device`, loaded strictly from `statedict` (keys with or
    without 'module.') and folded: {attribute path -> folded layer list}."""
    with torch.device("meta"):
        module = Net(num_1d)
    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in statedict.items()}
    module = module.to_empty(device=device)
    module.load_state_dict(sd, strict=True)
    return {path: _fold(sub) for path, sub in module.named_modules()
            if isinstance(sub, nn.Sequential)}


class Forward1M(Forward):
    """`Forward` with the track head's sigmoid."""

    def seq(self, layers, x):
        if layers and isinstance(layers[-1], nn.Sigmoid):
            return torch.sigmoid(super().seq(layers[:-1], x))
        return super().seq(layers, x)


@torch.no_grad()
def window_forward(model, packed: torch.Tensor, fwd: Forward,
                   rc_average: bool = True, dtype=torch.float32):
    """One window, `packed` (1, L, 4) uint8 on the model's device ->
    (map (L/4000, L/4000), tracks (L/4000, num_1d)) tensors in `dtype`, the
    model's (`cast`)."""
    rows = packed
    if rc_average:
        rows = torch.cat([packed, torch.flip(packed, dims=(1, 2))])
    x = rows.to(dtype).mul_(0.25).transpose(1, 2).contiguous()
    feats = fwd.tower(model, x)  # (R, 128, bins)
    maps = fwd.decoder1m(model, feats)[:, 0]  # (R, bins, bins)
    tracks = fwd.seq(model["final_1d"], feats)  # (R, num_1d, bins)
    if rc_average:
        maps = 0.5 * maps[0] + 0.5 * torch.flip(maps[1], dims=(0, 1))
        tracks = 0.5 * tracks[0] + 0.5 * torch.flip(tracks[1], dims=(1,))
    else:
        maps, tracks = maps[0], tracks[0]
    return maps, tracks.transpose(0, 1)


def predict(model, packed: torch.Tensor, precision: str = "fp32",
            rc_average: bool = True, dtype=torch.float32):
    """Windows (N, L, 4) packed uint8 on the model's device -> (maps
    (N, L/4000, L/4000), tracks (N, L/4000, num_1d)), numpy float32
    (float64 where `dtype` is)."""
    fwd = Forward1M(precision)
    out = torch.float64 if dtype == torch.float64 else torch.float32
    maps, tracks = [], []
    for w in range(packed.shape[0]):
        m, t = window_forward(model, packed[w:w + 1], fwd, rc_average, dtype)
        maps.append(m.to(out).cpu().numpy())
        tracks.append(t.to(out).cpu().numpy())
    return np.stack(maps), np.stack(tracks)


def cast(model, dtype):
    """A copy of a loaded model with its layers in `dtype`: run with that
    `dtype`, float64 gives the exact answer and bfloat16 a bfloat16
    computation, which tests hold the program's to."""
    return {path: [copy.deepcopy(m).to(dtype) for m in layers]
            for path, layers in model.items()}

