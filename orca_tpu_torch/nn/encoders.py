"""Orca encoder towers (counterpart of orca_tpu/nn/encoders.py).

  * the bp-resolution tower: one-hot (N, L, 4) -> 128ch features at 4 kb bins;
  * the pyramid: 4 kb -> 128 kb, U-Net style with `up_pass`.

The tower runs blocked: the sequence is cut into blocks with a halo that
covers its receptive field, so blocked and monolithic runs agree; positions
outside the real sequence are zeroed after every conv (masked execution).
With folded parameters each stage runs as one fused conv-chain kernel
(`apply_encoder_stages_fused`), which is the only path on a CUDA tensor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from orca_tpu_torch.nn.core import apply_block, apply_unit, conv_pair_1d, init_block
from orca_tpu_torch.ops import nn_ops
from orca_tpu_torch.ops.kernels.conv_chain import (
    fused_conv_chain,
    fused_first_stage,
)
from orca_tpu_torch.utils.config import get_config

# (cin, cout) and pre-pool of the tower's 7 stages; pools multiply to 4000.
STAGES = (
    (4, 64, 0),
    (64, 96, 4),
    (96, 128, 4),
    (128, 128, 5),
    (128, 128, 5),
    (128, 128, 5),
    (128, 128, 2),
)
BIN_BP = 4000
# Radius of the tower's receptive field in bp: sum over stages of
# 16 * cumulative pool (4 convs of k=9 per stage).
RECEPTIVE_FIELD_BP = 104016


def encoder_tower_spec() -> dict:
    return {
        "lconv": [
            conv_pair_1d(ci, co, relu=False, pool=p) for ci, co, p in STAGES
        ],
        "conv": [conv_pair_1d(co, co, relu=True) for _, co, _ in STAGES],
    }


def init_encoder_tower(gen: torch.Generator) -> dict:
    spec = encoder_tower_spec()
    return {name: [init_block(gen, b) for b in blocks]
            for name, blocks in spec.items()}


def apply_encoder_stages(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The 7 residual stages on (N, L, 4) -> (N, L/4000, 128). Stage i+1
    consumes conv_i(lconv_i(x)) + lconv_i(x); the tower returns the last
    stage's conv output without the residual."""
    spec = encoder_tower_spec()
    out = cout = x
    for lb, lp, cb, cp in zip(spec["lconv"], params["lconv"], spec["conv"],
                              params["conv"]):
        lout = apply_block(lp, lb, out)
        cout = apply_block(cp, cb, lout)
        out = cout + lout
    return cout


def to_compute_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 inputs are packed quarter-scale one-hot (one-hot * 4): scale
    back by 0.25 after the cast."""
    if x.dtype == torch.uint8:
        return x.to(dtype) * 0.25
    return x.to(dtype)


def pack_onehot(sequence) -> np.ndarray:
    """Host-side packing: float one-hot (values in {0, 0.25, 1}) -> uint8
    quarter-scale (values in {0, 1, 4}). Exact round trip."""
    return (np.asarray(sequence) * 4).astype(np.uint8)


def _per_row(bound, n: int) -> List[int]:
    """A scalar or per-row sequence of bounds -> one int per row."""
    if isinstance(bound, (int, np.integer)):
        return [int(bound)] * n
    vals = [int(v) for v in bound]
    return vals * n if len(vals) == 1 else vals


def apply_encoder_stages_masked(params: dict, x: torch.Tensor, valid_start_bp,
                                valid_end_bp) -> torch.Tensor:
    """apply_encoder_stages over an array whose positions outside
    [valid_start_bp, valid_end_bp) (ints, or one per row; multiples of 4000)
    lie outside the sequence: they are zeroed after every conv, which equals
    the monolithic tower's per-layer zero padding at the sequence boundary."""
    spec = encoder_tower_spec()
    n = x.shape[0]
    vs = torch.tensor(_per_row(valid_start_bp, n), device=x.device)
    ve = torch.tensor(_per_row(valid_end_bp, n), device=x.device)

    def run_block(block_params, block, arr, res):
        if block.pool:
            arr = nn_ops.maxpool1d(arr, block.pool)
            res *= block.pool
        idx = torch.arange(arr.shape[1], device=x.device)
        m = ((idx[None, :] >= (vs // res)[:, None])
             & (idx[None, :] < (ve // res)[:, None]))[:, :, None]
        for p, u in zip(block_params, block.units):
            arr = apply_unit(p, u, arr) * m.to(arr.dtype)
        return arr, res

    out = cout = x
    res = 1
    for lb, lp, cb, cp in zip(spec["lconv"], params["lconv"], spec["conv"],
                              params["conv"]):
        lout, res = run_block(lp, lb, out, res)
        cout, _ = run_block(cp, cb, lout, res)
        out = cout + lout
    return cout


def apply_encoder_stages_fused(params: dict, x: torch.Tensor, valid_start_bp,
                               valid_end_bp) -> torch.Tensor:
    """apply_encoder_stages_masked with each stage's conv chain as one fused
    kernel (counterpart of apply_encoder_stages_pallas): convs, biases, ReLUs,
    residual, masking and the next stage's max-pool per kernel launch.

    x: (N, L, 4) uint8 quarter-scale one-hot or float; params folded (no
    BatchNorm). Computes in the parameter dtype."""
    if "bn" in params["lconv"][0][0]:
        raise ValueError("the fused encoder path needs folded parameters "
                         "(nn.core.fold_params)")
    n, length, _ = x.shape
    dtype = params["lconv"][0][0]["w"].dtype
    if x.dtype != torch.uint8:
        x = x.to(dtype)
    vs_bp = torch.tensor(_per_row(valid_start_bp, n), dtype=torch.int32,
                         device=x.device)
    ve_bp = torch.tensor(_per_row(valid_end_bp, n), dtype=torch.int32,
                         device=x.device)
    lp, cp = params["lconv"], params["conv"]

    def wb(unit):
        return unit["w"], unit["b"]

    pools = [p for _, _, p in STAGES] + [1]
    res = 1
    out = x
    for i in range(len(STAGES)):
        res *= pools[i] or 1
        vs, ve = vs_bp // res, ve_bp // res
        if i == 0:
            out = fused_first_stage(
                out, wb(lp[0][0]), (wb(lp[0][1]), wb(cp[0][0]), wb(cp[0][1])),
                vs, ve, relus=(False, True, True), residual_idx=0,
                out_pool=pools[1],
            )
        else:
            out = fused_conv_chain(
                out,
                (wb(lp[i][0]), wb(lp[i][1]), wb(cp[i][0]), wb(cp[i][1])),
                vs, ve, relus=(False, False, True, True),
                # the last stage returns the conv-pair output alone
                residual_idx=1 if i < len(STAGES) - 1 else -1,
                out_pool=pools[i + 1],
            )
    return out


def _group_plan(n: int, nblocks: int, block_bp: int,
                block_group: Optional[int]) -> Tuple[int, int]:
    """(rchunk, bpg): batch rows and blocks per group of the blocked tower;
    a group holds at most `block_group` (default ~16 Mb of sequence) rows."""
    rows_cap = block_group or min(nblocks * n, max(1, 16_000_000 // block_bp))
    if n > rows_cap:
        rchunk = max(d for d in range(1, rows_cap + 1) if n % d == 0)
    else:
        rchunk = n
    bpg = max(1, min(nblocks, rows_cap // rchunk or 1))
    while nblocks % bpg:
        bpg -= 1
    return rchunk, bpg


def _default_blocking(n: int, length: int,
                      block_group: Optional[int]) -> Tuple[Optional[int], Optional[int]]:
    """(block_bp, block_group) of the tower's default blocking: the config's
    kernel_block_bp in groups of ~8 Mb of sequence; block_bp None when the
    whole input fits two blocks and runs as one piece."""
    block_bp = get_config().kernel_block_bp
    if n * length <= 2 * block_bp:
        return None, block_group
    return block_bp, block_group or max(1, 8_000_000 // block_bp)


def fused_group_count(n: int, length: int) -> int:
    """How many times `apply_encoder_tower` runs the fused stages (so each
    fused kernel launches) for an (n, length) input at the default blocking."""
    block_bp, block_group = _default_blocking(n, length, None)
    if block_bp is None or length <= block_bp:
        return 1
    nblocks = -(-length // block_bp)
    rchunk, bpg = _group_plan(n, nblocks, block_bp, block_group)
    return (nblocks // bpg) * (n // rchunk)


def apply_encoder_tower(params: dict, x: torch.Tensor, *,
                        block_bp: Optional[int] = None, halo_bp: int = 112000,
                        block_group: Optional[int] = None,
                        valid_start_bp: Optional[int] = None,
                        valid_end_bp: Optional[int] = None) -> torch.Tensor:
    """bp -> 4 kb encoder forward with blocked execution.

    x: (N, L, 4) one-hot (uint8 quarter-scale or float). block_bp: block
        length (default: the config's kernel_block_bp); blocks get a
        `halo_bp` halo each side and run `block_group` rows at a time (bounds
        peak memory). All multiples of 4000; halo >= RECEPTIVE_FIELD_BP makes
        blocked execution equal to the monolithic conv.
    valid_start_bp / valid_end_bp: optional bounds of the real sequence
        inside x (multiples of 4000).

    A CUDA tensor always runs the fused kernels: it needs folded parameters
    (models.zoo.fold_bundle) and a length that is a multiple of 4000, and
    raises otherwise. On the CPU, unfolded parameters or another length take
    the plain unfused stages.
    """
    param_dtype = params["lconv"][0][0]["w"].dtype
    if param_dtype == torch.bfloat16:
        compute_dtype = torch.bfloat16
    elif x.dtype in (torch.float32, torch.bfloat16):
        compute_dtype = x.dtype
    else:
        compute_dtype = torch.float32
    n, length, _ = x.shape
    bounded = valid_start_bp is not None or valid_end_bp is not None
    vs0 = valid_start_bp if valid_start_bp is not None else 0
    ve0 = valid_end_bp if valid_end_bp is not None else length
    fused = "bn" not in params["lconv"][0][0] and length % BIN_BP == 0
    if x.is_cuda and not fused:
        raise ValueError(
            "on CUDA the encoder tower runs the fused kernels, which need "
            "folded parameters (models.zoo.fold_bundle) and a sequence length "
            f"that is a multiple of 4000; got {length=}, folded="
            f"{'bn' not in params['lconv'][0][0]}"
        )

    def stages(seg, vs, ve):
        if fused:
            return apply_encoder_stages_fused(params, seg, vs, ve)
        seg = to_compute_dtype(seg, compute_dtype)
        if bounded or not isinstance(vs, int):
            return apply_encoder_stages_masked(params, seg, vs, ve)
        return apply_encoder_stages(params, seg)

    if block_bp is None:
        block_bp, block_group = _default_blocking(n, length, block_group)
    if block_bp is None or length <= block_bp:
        return stages(x, vs0, ve0)

    if block_bp % BIN_BP or halo_bp % BIN_BP or length % BIN_BP:
        raise ValueError(
            "block_bp, halo_bp and the sequence length must be multiples of "
            f"4000; got {block_bp=} {halo_bp=} {length=}"
        )
    nblocks = -(-length // block_bp)  # ceil: last block zero-padded + masked
    halo_bins = halo_bp // BIN_BP
    block_bins = block_bp // BIN_BP
    seg_bp = block_bp + 2 * halo_bp
    pad_tail = nblocks * block_bp - length + halo_bp
    xp = torch.cat([
        x.new_zeros((n, halo_bp, x.shape[2])), x,
        x.new_zeros((n, pad_tail, x.shape[2])),
    ], dim=1)

    rchunk, bpg = _group_plan(n, nblocks, block_bp, block_group)
    out = None
    for r0 in range(0, n, rchunk):
        for b0 in range(0, nblocks, bpg):
            blocks = range(b0, b0 + bpg)
            seg = torch.cat([
                xp[r0 : r0 + rchunk, b * block_bp : b * block_bp + seg_bp]
                for b in blocks
            ])
            # per-row valid bp range (sequence bounds + tail padding),
            # block-major rows as in the concatenation above
            seg_start = [b * block_bp - halo_bp for b in blocks]
            gvs = [min(max(vs0 - s, 0), seg_bp) for s in seg_start
                   for _ in range(rchunk)]
            gve = [min(max(ve0 - s, 0), seg_bp) for s in seg_start
                   for _ in range(rchunk)]
            enc = stages(seg, gvs, gve)[:, halo_bins : halo_bins + block_bins]
            if out is None:
                out = enc.new_empty((n, nblocks * block_bins, enc.shape[2]))
            for j, b in enumerate(blocks):
                out[r0 : r0 + rchunk, b * block_bins : (b + 1) * block_bins] = (
                    enc[j * rchunk : (j + 1) * rchunk]
                )
    return out[:, : length // BIN_BP]


# --------------------------------------------------------------------------
# Pyramid encoder (4 kb -> 128 kb)
# --------------------------------------------------------------------------


def pyramid_spec(levels: int, up_pass: bool) -> dict:
    spec = {
        "lblocks": [conv_pair_1d(128, 128, relu=False, pool=2)
                    for _ in range(levels)],
        "blocks": [conv_pair_1d(128, 128, relu=True) for _ in range(levels)],
    }
    if up_pass:
        spec["downl"] = [conv_pair_1d(128, 128, relu=False, upsample=2)
                         for _ in range(levels)]
        # up-pass active blocks lack BatchNorm on their second conv
        spec["down"] = [conv_pair_1d(128, 128, relu=True, second_bn=False)
                        for _ in range(levels)]
    return spec


def init_pyramid(gen: torch.Generator, levels: int, up_pass: bool) -> dict:
    spec = pyramid_spec(levels, up_pass)
    return {name: [init_block(gen, b) for b in blocks]
            for name, blocks in spec.items()}


def apply_pyramid(params: dict, x: torch.Tensor, *, levels: int,
                  up_pass: bool) -> List[torch.Tensor]:
    """Returns `levels + 1` encodings, finest first. With up_pass: U-Net,
    the down pass halves the resolution per level, the up pass doubles it
    back and adds the matching down encoding."""
    spec = pyramid_spec(levels, up_pass)
    out = x
    encodings = [out]
    for lb, lp, cb, cp in zip(spec["lblocks"], params["lblocks"],
                              spec["blocks"], params["blocks"]):
        lout = apply_block(lp, lb, out)
        out = apply_block(cp, cb, lout) + lout
        encodings.append(out)
    if not up_pass:
        return encodings
    encodings2 = [out]
    for enc, lb, lp, cb, cp in zip(reversed(encodings[:-1]), spec["downl"],
                                   params["downl"], spec["down"],
                                   params["down"]):
        lout = apply_block(lp, lb, out)
        out = apply_block(cp, cb, lout) + lout
        out = enc + out
        encodings2.append(out)
    encodings2.reverse()
    return encodings2
