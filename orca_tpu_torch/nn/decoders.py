"""Orca 2D decoders (counterpart of orca_tpu/nn/decoders.py).

  * `decoder_*`: the per-level pairwise decoder with distance encoding and
    optional coarse-prediction refinement;
  * `decoder1m_*`: the 19-block decoder of the 1 Mb model, added at level 1
    of the 32 Mb cascade;
  * `apply_net`: the standalone 1 Mb model (tower, `Decoder_1m` and the
    optional 1D track head).

All 2D work is (N, H, W, C) on crop x crop maps; the convs run as cuDNN
convolutions in the channels-last memory format.

Training mode (`train=True`) runs the same blocks with dropout, batch
statistics and recorded BatchNorm updates (nn.core); `remat_blocks` and
`remat` recompute activations in the backward (`torch.utils.checkpoint`);
a dropout mask is a pure function of its key (utils.rng), so the recompute
draws it again equal.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from orca_tpu_torch.nn import encoders
from orca_tpu_torch.nn.core import (
    Block,
    BNUpdates,
    Unit,
    apply_block,
    conv_pair_2d,
    init_block,
)
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


def _recompute(fn, *args):
    """fn(*args) with its activations recomputed in the backward. The
    default generators' states are not saved: the draws inside come from
    generators seeded by their keys."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def apply_decoder(params: dict, x: torch.Tensor, distenc: torch.Tensor,
                  y: Optional[torch.Tensor] = None, *, num_2d: int = 1,
                  upsample_mode: str = "bilinear", train: bool = False,
                  rng: Optional[int] = None,
                  bn_updates: Optional[BNUpdates] = None, path: str = "",
                  remat_blocks: bool = False) -> torch.Tensor:
    """Per-level decoder forward.

    x: (N, crop, 128) encoding crop; distenc: (N, crop, crop, num_2d) log
    background; y: optional (N, crop/2, crop/2, num_2d) coarse prediction of
    the parent level. Returns the (N, crop, crop, num_2d) symmetric map.

    Training: every block takes the same `rng`, as in the JAX package, so
    same-shaped dropout units draw the same mask. remat_blocks checkpoints
    each block, keeping only its input for the backward.
    """
    spec = decoder_spec(num_2d)
    pre = f"{path}/" if path else ""
    kw = dict(train=train, rng=rng, bn_updates=bn_updates)

    if train and remat_blocks:
        def block(p, b, cur, bpath):
            def f(cur):
                local = BNUpdates(group=getattr(bn_updates, "group", None))
                out = apply_block(p, b, cur, train=True, rng=rng,
                                  bn_updates=local, path=bpath)
                return out, local.updates

            out, upd = _recompute(f, cur)
            if bn_updates is not None:
                bn_updates.updates.update(upd)
            return out
    else:
        def block(p, b, cur, bpath):
            return apply_block(p, b, cur, path=bpath, **kw)

    distenc = distenc.to(x.dtype)
    mat = torch.cat([pairwise(x), distenc], dim=-1)
    mat = block(params["lcombinerD"], spec["lcombinerD"], mat,
                f"{pre}lcombinerD")
    mat = block(params["combinerD"], spec["combinerD"], mat,
                f"{pre}combinerD") + mat
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
            cur = block(params["lcombiner"], spec["lcombiner"], cur,
                        f"{pre}lcombiner")
            cur = block(params["combiner"], spec["combiner"], cur,
                        f"{pre}combiner") + cur
            continue
        lout = block(lp, lb, cur, f"{pre}lconvtwos/{i}")
        # the very first block has no residual (it has no coarse map input)
        cur = lout if i == 0 else lout + cur
        cur = block(cp, cb, cur, f"{pre}convtwos/{i}") + cur
    cur = block(params["final"], spec["final"], cur, f"{pre}final")
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
                        num_2d: int = 1, train: bool = False,
                        rng: Optional[int] = None,
                        bn_updates: Optional[BNUpdates] = None,
                        path: str = "") -> torch.Tensor:
    """2D stack over an already-built pairwise map (N, crop, crop, 128).
    Every block takes the same `rng`."""
    spec = decoder1m_spec(num_2d)
    pre = f"{path}/" if path else ""
    kw = dict(train=train, rng=rng, bn_updates=bn_updates)
    cur = mat
    for i, (lb, lp, cb, cp) in enumerate(zip(
        spec["lconvtwos"], params["lconvtwos"], spec["convtwos"],
        params["convtwos"],
    )):
        lout = apply_block(lp, lb, cur, path=f"{pre}lconvtwos/{i}", **kw)
        # the first block maps 128 -> 64 channels: no residual
        cur = lout if i == 0 else lout + cur
        cur = apply_block(cp, cb, cur, path=f"{pre}convtwos/{i}", **kw) + cur
    cur = apply_block(params["final"], spec["final"], cur,
                      path=f"{pre}final", **kw)
    return symmetrize(cur)


def apply_decoder1m(params: dict, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """(N, crop, 128) encoding -> (N, crop, crop, num_2d) map."""
    return apply_decoder1m_mat(params, pairwise(x), **kwargs)


# --------------------------------------------------------------------------
# Net: the standalone 1 Mb model
# --------------------------------------------------------------------------


def final1d_spec(num_1d: int) -> Block:
    return Block(
        units=(
            Unit(1, 128, 128, k=1, bn=True, relu=True),
            Unit(1, 128, num_1d, k=1, bn=False, sigmoid=True),
        )
    )


def net_spec(num_1d: Optional[int] = None, num_2d: int = 1) -> dict:
    """The spec tree of `init_net`'s parameters (for fold_params)."""
    spec = {"encoder": encoders.encoder_tower_spec(),
            "decoder": decoder1m_spec(num_2d)}
    if num_1d:
        spec["final_1d"] = final1d_spec(num_1d)
    return spec


def init_net(gen: torch.Generator, num_1d: Optional[int] = None,
             num_2d: int = 1) -> dict:
    params = {
        "encoder": encoders.init_encoder_tower(gen),
        "decoder": init_decoder1m(gen, num_2d),
    }
    if num_1d:
        params["final_1d"] = init_block(gen, final1d_spec(num_1d))
    return params


def apply_net(params: dict, x: torch.Tensor, *, num_1d: Optional[int] = None,
              num_2d: int = 1, train: bool = False, rng: Optional[int] = None,
              bn_updates: Optional[BNUpdates] = None, remat: bool = False):
    """1 Mb model forward: (N, L, 4) one-hot (uint8 quarter-scale or float)
    -> (N, L/4000, L/4000, num_2d) map, and the (N, L/4000, num_1d) tracks
    when num_1d is set.

    Inference: the tower runs as one piece (`encoders.apply_encoder_tower`):
    on a CUDA tensor through the fused kernels on folded parameters, with the
    valid range the whole window, which equals the JAX package's unfused
    stages with zero padding at the window's edges; unfolded parameters
    raise there.

    Training (`train=True`, unfolded parameters, float32): the tower's plain
    stages under autograd, then the 2D stack. remat checkpoints the two
    segments, the tower and the 2D stack, as the JAX package does.
    """
    if not train:
        out7 = encoders.apply_encoder_tower(params["encoder"], x)
        pred = apply_decoder1m_mat(params["decoder"], pairwise(out7),
                                   num_2d=num_2d)
        if num_1d:
            return pred, apply_block(params["final_1d"],
                                     final1d_spec(num_1d), out7)
        return pred

    x = encoders.to_compute_dtype(
        x, params["encoder"]["lconv"][0][0]["w"].dtype)

    def run_encoder(x):
        local = BNUpdates(group=getattr(bn_updates, "group", None))
        out = encoders.apply_encoder_stages(params["encoder"], x, train=True,
                                            rng=rng, bn_updates=local,
                                            path="encoder")
        return out, local.updates

    def run_decoder(mat):
        local = BNUpdates(group=getattr(bn_updates, "group", None))
        out = apply_decoder1m_mat(params["decoder"], mat, num_2d=num_2d,
                                  train=True, rng=rng, bn_updates=local,
                                  path="decoder")
        return out, local.updates

    if remat:
        out7, enc_updates = _recompute(run_encoder, x)
        pred, dec_updates = _recompute(run_decoder, pairwise(out7))
    else:
        out7, enc_updates = run_encoder(x)
        pred, dec_updates = run_decoder(pairwise(out7))
    if bn_updates is not None:
        bn_updates.updates.update(enc_updates)
        bn_updates.updates.update(dec_updates)
    if num_1d:
        out1d = apply_block(params["final_1d"], final1d_spec(num_1d), out7,
                            train=True, rng=rng, bn_updates=bn_updates,
                            path="final_1d")
        return pred, out1d
    return pred
