"""Spec-driven conv blocks (counterpart of orca_tpu/nn/core.py).

Blocks are data: a `Block` spec plus a parameter tree consumed by
`apply_block`. The tree for a Block is a list (one entry per Unit) of dicts
{'w': (K.., Cin, Cout), 'b': (Cout,), optional 'bn': {scale, bias, mean,
var}}, tensors in the JAX layout. Inference parameters carry no BatchNorm:
`fold_params` absorbs it into the conv weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from orca_tpu_torch.ops import nn_ops


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


def apply_unit(params: dict, unit: Unit, x: torch.Tensor) -> torch.Tensor:
    """Inference: conv -> BN -> ReLU/sigmoid (dropout is the identity)."""
    conv = nn_ops.conv1d if unit.dim == 1 else nn_ops.conv2d
    x = conv(x, params["w"], params["b"], dilation=unit.dilation)
    if "bn" in params:
        bn = params["bn"]
        x = nn_ops.batchnorm(x, bn["scale"], bn["bias"], bn["mean"], bn["var"])
    if unit.relu:
        x = nn_ops.relu(x)
    if unit.sigmoid:
        x = nn_ops.sigmoid(x)
    return x


def apply_block(params: list, block: Block, x: torch.Tensor) -> torch.Tensor:
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
    for p, u in zip(params, block.units):
        x = apply_unit(p, u, x)
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
