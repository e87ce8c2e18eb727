"""Spec-driven conv blocks (counterpart of orca_tpu/nn/core.py).

Blocks are data: a `Block` spec plus a parameter tree consumed by
`apply_block`. The tree for a Block is a list (one entry per Unit) of dicts
{'w': (K.., Cin, Cout), 'b': (Cout,), optional 'bn': {scale, bias, mean,
var}}, tensors in the JAX layout. Inference parameters carry no BatchNorm:
`fold_params` absorbs it into the conv weights.

Training mode (`train=True`): dropout before the conv with a mask drawn from
the unit's key (utils.rng), BatchNorm on batch statistics, and the running
statistics' update recorded by path in a `BNUpdates`, never written in
place, so a recomputed forward cannot apply it twice.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch

from orca_tpu_torch.ops import nn_ops
from orca_tpu_torch.utils import rng as rng_lib


@dataclasses.dataclass(frozen=True)
class Unit:
    """One conv (+BN)(+activation) step."""

    dim: int  # 1 or 2 (spatial dims)
    cin: int
    cout: int
    k: int = 9
    dilation: int = 1
    bn: bool = True
    relu: bool = False
    sigmoid: bool = False
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class Block:
    """A motif: optional pool/upsample followed by a chain of Units."""

    units: tuple
    pool: int = 0  # maxpool kernel == stride before the units (1D only)
    upsample: int = 0  # nearest-upsample scale before the units
    upsample_mode: str = "nearest"  # for 2D coarse-pred upsampling


def conv_pair_1d(cin: int, cout: int, *, relu: bool, pool: int = 0,
                 upsample: int = 0, second_bn: bool = True) -> Block:
    """The 1D motif: two k=9 convs; relu=False is the 'lconv' flavour,
    relu=True the 'conv' flavour."""
    return Block(
        units=(
            Unit(1, cin, cout, k=9, relu=relu),
            Unit(1, cout, cout, k=9, relu=relu, bn=second_bn),
        ),
        pool=pool,
        upsample=upsample,
    )


def conv_pair_2d(cin: int, cmid: int, cout: int, dilation: int, *, relu: bool,
                 dropout: float = 0.0, k: int = 3) -> Block:
    """The 2D motif: a dilated conv pair, cin -> cmid -> cout."""
    return Block(
        units=(
            Unit(2, cin, cmid, k=k, dilation=dilation, relu=relu,
                 dropout=dropout),
            Unit(2, cmid, cout, k=k, dilation=dilation, relu=relu),
        )
    )


def _init_unit(gen: torch.Generator, unit: Unit) -> dict:
    """torch's Conv default init: weight and bias U(-l, l), l = 1/sqrt(fan_in);
    BatchNorm at identity statistics. float32 on the generator's device."""
    kshape = (unit.k,) * unit.dim + (unit.cin, unit.cout)
    limit = 1.0 / math.sqrt(unit.cin * unit.k ** unit.dim)
    dev = gen.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * (2 * limit) - limit

    p = {"w": uniform(*kshape), "b": uniform(unit.cout)}
    if unit.bn:
        p["bn"] = {
            "scale": torch.ones(unit.cout, device=dev),
            "bias": torch.zeros(unit.cout, device=dev),
            "mean": torch.zeros(unit.cout, device=dev),
            "var": torch.ones(unit.cout, device=dev),
        }
    return p


def init_block(gen: torch.Generator, block: Block) -> list:
    return [_init_unit(gen, u) for u in block.units]


class BNUpdates:
    """Collects training-mode BatchNorm running-statistic updates of a
    forward, keyed by the unit's path in the parameter tree ("<block
    path>/<unit index>"); `merge_bn_updates` writes them back after the
    step. Momentum 0.1, from the unbiased batch variance (torch's rule).

    group: the forward's data-parallel group (parallel.multihost.DataGroup)
    or None for one process; with a group, batch statistics and dropout
    masks are the global batch's."""

    def __init__(self, momentum: float = 0.1, *, group=None):
        self.momentum = momentum
        self.group = group
        self.updates = {}  # path -> (new running mean, new running var)

    def record(self, path, mean, var_unbiased):
        self.updates[path] = (mean, var_unbiased)


def merge_bn_updates(params, bn_updates: BNUpdates):
    """A copy of `params` with the recorded running statistics written back.
    Paths address dict keys and list indices, e.g. "encoder/lconv/0/1" ->
    params["encoder"]["lconv"][0][1]["bn"]; int-keyed dicts (decoder levels)
    are addressed by the key's digits."""
    out = copy.copy(params) if isinstance(params, dict) else list(params)

    def _set(tree, parts, mean, var):
        head = parts[0]
        if isinstance(tree, list) or head not in tree:
            key = int(head)
        else:
            key = head
        if len(parts) == 1:
            unit = dict(tree[key])
            unit["bn"] = dict(unit["bn"], mean=mean, var=var)
            tree[key] = unit
        else:
            child = tree[key]
            child = (copy.copy(child) if isinstance(child, dict)
                     else list(child))
            tree[key] = child
            _set(child, parts[1:], mean, var)

    for path, (mean, var) in bn_updates.updates.items():
        _set(out, path.split("/"), mean, var)
    return out


def apply_unit(params: dict, unit: Unit, x: torch.Tensor, *,
               train: bool = False, rng: Optional[int] = None,
               bn_updates: Optional[BNUpdates] = None, path: str = ""
               ) -> torch.Tensor:
    """dropout (train) -> conv -> BN -> ReLU/sigmoid. In training mode the
    dropout mask is drawn from `rng`: a pure function of the key, so a
    forward recomputed under torch.utils.checkpoint draws it again equal.
    Over a data-parallel group (`bn_updates.group`) the mask is drawn at the
    global batch's shape and this rank keeps its rows: the one-process
    step's mask, sliced."""
    group = bn_updates.group if bn_updates is not None else None
    if unit.dropout > 0.0 and train:
        if rng is None:
            raise ValueError("dropout in train mode requires an rng")
        if group is None:
            mask = rng_lib.bernoulli(rng, 1.0 - unit.dropout, x.shape,
                                     x.device)
        else:
            n = x.shape[0]
            mask = rng_lib.bernoulli(
                rng, 1.0 - unit.dropout, (n * group.world,) + x.shape[1:],
                x.device)[group.rank * n:(group.rank + 1) * n]
        x = nn_ops.dropout(x, unit.dropout, mask)
    conv = nn_ops.conv1d if unit.dim == 1 else nn_ops.conv2d
    x = conv(x, params["w"], params["b"], dilation=unit.dilation)
    if "bn" in params:
        bn = params["bn"]
        if train:
            x, bmean, _bvar, bvar_u = nn_ops.batchnorm_train(
                x, bn["scale"], bn["bias"], group=group)
            if bn_updates is not None:
                m = bn_updates.momentum
                bn_updates.record(
                    path,
                    ((1 - m) * bn["mean"] + m * bmean).detach(),
                    ((1 - m) * bn["var"] + m * bvar_u).detach(),
                )
        else:
            x = nn_ops.batchnorm(x, bn["scale"], bn["bias"], bn["mean"],
                                 bn["var"])
    if unit.relu:
        x = nn_ops.relu(x)
    if unit.sigmoid:
        x = nn_ops.sigmoid(x)
    return x


def apply_block(params: list, block: Block, x: torch.Tensor, *,
                train: bool = False, rng: Optional[int] = None,
                bn_updates: Optional[BNUpdates] = None, path: str = ""
                ) -> torch.Tensor:
    """Pool/upsample, then the units. Unit i takes the i-th key of
    split(rng) and the path "<path>/<i>"."""
    if block.pool:
        x = nn_ops.maxpool1d(x, block.pool)
    if block.upsample:
        if block.units and block.units[0].dim == 2:
            if block.upsample_mode == "bilinear":
                x = nn_ops.upsample2d_bilinear(x, block.upsample)
            else:
                x = nn_ops.upsample2d_nearest(x, block.upsample)
        else:
            x = nn_ops.upsample1d_nearest(x, block.upsample)
    keys = (rng_lib.split(rng, len(block.units)) if rng is not None
            else [None] * len(block.units))
    for i, (p, u, k) in enumerate(zip(params, block.units, keys)):
        x = apply_unit(p, u, x, train=train, rng=k, bn_updates=bn_updates,
                       path=f"{path}/{i}" if path else str(i))
    return x


def fold_params(params, spec):
    """Recursively fold BN into conv weights for inference. `params`/`spec`
    may be (unit dict, Unit), (list, Block), or dict/list nestings of them."""
    if isinstance(spec, Block):
        return [fold_params(p, u) for p, u in zip(params, spec.units)]
    if isinstance(spec, Unit):
        if "bn" in params:
            w, b = nn_ops.fold_bn_into_conv(params["w"], params["b"],
                                            params["bn"])
            return {"w": w, "b": b}
        return {"w": params["w"], "b": params["b"]}
    if isinstance(spec, dict):
        return {k: fold_params(params[k], spec[k]) for k in spec}
    if isinstance(spec, (list, tuple)):
        return [fold_params(p, s) for p, s in zip(params, spec)]
    raise TypeError(f"unsupported spec node: {type(spec)}")
