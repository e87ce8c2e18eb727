"""Orca 2D decoders (counterpart of orca_tpu/nn/decoders.py), inference.

  * `decoder_*`: the per-level pairwise decoder with distance encoding and
    optional coarse-prediction refinement;
  * `decoder1m_*`: the 19-block decoder of the 1 Mb model, added at level 1
    of the 32 Mb cascade.

All 2D work is (N, H, W, C) on crop x crop maps; the convs run as cuDNN
convolutions in the channels-last memory format.
"""

from __future__ import annotations

from typing import Optional

import torch

from orca_tpu_torch.nn.core import Block, Unit, apply_block, conv_pair_2d, init_block
from orca_tpu_torch.ops import nn_ops

# Dilation schedules: Decoder uses 4 groups of (1..64); Decoder_1m one group
# of 7 then 2 groups of 6.
DILATIONS_DECODER = (1, 2, 4, 8, 16, 32, 64) * 4
DILATIONS_1M = (1, 2, 4, 8, 16, 32, 64) + (2, 4, 8, 16, 32, 64) * 2


def pairwise(x: torch.Tensor) -> torch.Tensor:
    """(N, L, C) -> (N, L, L, C) outer sum: mat[i, j] = x[i] + x[j]."""
    return x[:, :, None, :] + x[:, None, :, :]


def _head_block(num_2d: int) -> Block:
    cmid = max(num_2d, 5)
    return Block(
        units=(
            Unit(2, 64, cmid, k=1, bn=True, relu=True),
            Unit(2, cmid, num_2d, k=1, bn=False),
        )
    )


def decoder_spec(num_2d: int = 1) -> dict:
    twos = [
        conv_pair_2d(64, 32, 64, d, relu=False, dropout=0.1 if i == 0 else 0.0)
        for i, d in enumerate(DILATIONS_DECODER)
    ]
    twos_relu = [conv_pair_2d(64, 32, 64, d, relu=True)
                 for d in DILATIONS_DECODER]
    return {
        "lcombinerD": Block(units=(Unit(2, 128 + num_2d, 64, k=3),
                                   Unit(2, 64, 64, k=3))),
        "combinerD": Block(units=(Unit(2, 64, 64, k=3, relu=True),
                                  Unit(2, 64, 64, k=3, relu=True))),
        "lcombiner": Block(units=(Unit(2, 64 + num_2d, 64, k=3, dropout=0.1),
                                  Unit(2, 64, 64, k=3))),
        "combiner": Block(units=(Unit(2, 64, 64, k=3, relu=True),
                                 Unit(2, 64, 64, k=3, relu=True))),
        "lconvtwos": twos,
        "convtwos": twos_relu,
        "final": _head_block(num_2d),
    }


def _init_from_spec(gen: torch.Generator, spec: dict) -> dict:
    return {
        name: (init_block(gen, node) if isinstance(node, Block)
               else [init_block(gen, b) for b in node])
        for name, node in spec.items()
    }


def init_decoder(gen: torch.Generator, num_2d: int = 1) -> dict:
    return _init_from_spec(gen, decoder_spec(num_2d))


def _upsample_coarse(y: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bilinear":
        return nn_ops.upsample2d_bilinear(y, 2)
    return nn_ops.upsample2d_nearest(y, 2)


def symmetrize(m: torch.Tensor) -> torch.Tensor:
    """0.5*(M + M^T) over the two spatial axes of NHWC."""
    return 0.5 * m + 0.5 * m.transpose(1, 2)


def apply_decoder(params: dict, x: torch.Tensor, distenc: torch.Tensor,
                  y: Optional[torch.Tensor] = None, *, num_2d: int = 1,
                  upsample_mode: str = "bilinear") -> torch.Tensor:
    """Per-level decoder forward.

    x: (N, crop, 128) encoding crop; distenc: (N, crop, crop, num_2d) log
    background; y: optional (N, crop/2, crop/2, num_2d) coarse prediction of
    the parent level. Returns the (N, crop, crop, num_2d) symmetric map.
    """
    spec = decoder_spec(num_2d)
    distenc = distenc.to(x.dtype)
    mat = torch.cat([pairwise(x), distenc], dim=-1)
    mat = apply_block(params["lcombinerD"], spec["lcombinerD"], mat)
    mat = apply_block(params["combinerD"], spec["combinerD"], mat) + mat
    if y is not None:
        mat = torch.cat([mat, _upsample_coarse(y.to(x.dtype), upsample_mode)],
                        dim=-1)
    cur = mat
    for i, (lb, lp, cb, cp) in enumerate(zip(
        spec["lconvtwos"], params["lconvtwos"], spec["convtwos"],
        params["convtwos"],
    )):
        if i == 0 and y is not None:
            # with a coarse pred the combiner pair replaces the first block
            cur = apply_block(params["lcombiner"], spec["lcombiner"], cur)
            cur = apply_block(params["combiner"], spec["combiner"], cur) + cur
            continue
        lout = apply_block(lp, lb, cur)
        # the very first block has no residual (it has no coarse map input)
        cur = lout if i == 0 else lout + cur
        cur = apply_block(cp, cb, cur) + cur
    cur = apply_block(params["final"], spec["final"], cur)
    return symmetrize(cur)


def decoder1m_spec(num_2d: int = 1) -> dict:
    twos = [
        conv_pair_2d(128 if i == 0 else 64, 32, 64, d, relu=False,
                     dropout=0.1 if i == 0 else 0.0)
        for i, d in enumerate(DILATIONS_1M)
    ]
    twos_relu = [conv_pair_2d(64, 32, 64, d, relu=True) for d in DILATIONS_1M]
    return {"lconvtwos": twos, "convtwos": twos_relu,
            "final": _head_block(num_2d)}


def init_decoder1m(gen: torch.Generator, num_2d: int = 1) -> dict:
    return _init_from_spec(gen, decoder1m_spec(num_2d))


def apply_decoder1m_mat(params: dict, mat: torch.Tensor, *,
                        num_2d: int = 1) -> torch.Tensor:
    """2D stack over an already-built pairwise map (N, crop, crop, 128)."""
    spec = decoder1m_spec(num_2d)
    cur = mat
    for i, (lb, lp, cb, cp) in enumerate(zip(
        spec["lconvtwos"], params["lconvtwos"], spec["convtwos"],
        params["convtwos"],
    )):
        lout = apply_block(lp, lb, cur)
        # the first block maps 128 -> 64 channels: no residual
        cur = lout if i == 0 else lout + cur
        cur = apply_block(cp, cb, cur) + cur
    cur = apply_block(params["final"], spec["final"], cur)
    return symmetrize(cur)


def apply_decoder1m(params: dict, x: torch.Tensor, *,
                    num_2d: int = 1) -> torch.Tensor:
    """(N, crop, 128) encoding -> (N, crop, crop, num_2d) map."""
    return apply_decoder1m_mat(params, pairwise(x), num_2d=num_2d)
