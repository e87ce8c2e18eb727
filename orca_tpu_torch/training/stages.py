"""The three training stages' steps (counterpart of
orca_tpu/training/stages.py).

  * stage a: the 1 Mb `Net` on 1 kb micro-C, masked log-fold MSE plus BCE on
    the 1D chromatin tracks, 50% reverse-complement augmentation;
  * stage b: the pyramid and six decoders on 32 Mb windows, the stage-a
    tower and `Decoder_1m` frozen; a random zoom cascade whose coarse
    predictions are detached;
  * stage c: the 256 Mb pyramid and four decoders on cross-chromosome
    windows with per-sample background normmats.

A step takes and returns the JAX package's trees: (params, opt_state,
metrics), metrics as 0-d tensors. It runs forward and backward with TF32 off
(`nn_ops.full_fp32`), gradients from `torch.autograd`. The frozen tower runs
folded under `torch.no_grad()`: on a CUDA tensor that is the fused conv-chain
kernels (`encoders.apply_encoder_tower`), which have no backward. BatchNorm
running statistics are updated functionally and returned in the params.

Every draw of a step (the stage-a flip, the dropout masks, the zoom offsets)
goes through `utils.rng`. Kept from the JAX package: in stages b and c,
level j's key seeds both its decoder's dropout and its zoom offset.
Zoom offsets are drawn on the host, so the crops are plain slices.

Data parallelism (`group`, a parallel.multihost.DataGroup): each rank runs
its rows of the global batch; BatchNorm statistics, dropout masks and the
losses' denominators are the global batch's, so the ranks' losses and
gradients sum to the one-process step's. The gradient tree and the metrics
are summed over the ranks before the update, which every rank then applies
alike. BatchNorm running statistics need no all-reduce: their updates come
from global statistics. With no group the step makes no collective call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.nn.core import BNUpdates, fold_params, merge_bn_updates
from orca_tpu_torch.ops import nn_ops
from orca_tpu_torch.predict.multiscale import (
    GEOM_32M,
    GEOM_256M,
    CascadeGeometry,
)
from orca_tpu_torch.training import losses, optim
from orca_tpu_torch.utils import rng as rng_lib
from orca_tpu_torch.utils.config import resolve_device
from orca_tpu_torch.utils.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class StageAConfig:
    num_1d: Optional[int] = 32
    num_2d: int = 1  # output heads (multi-cell-type leukemia variants > 1)
    crop: int = 250  # output map bins
    target_factor: int = 4  # raw target bins per output bin (1kb -> 4kb)
    seq_len: int = 1_000_000
    momentum: float = 0.98
    remat: bool = True


def _align_heads(pred: torch.Tensor, num_2d: int) -> torch.Tensor:
    """(N, crop, crop, num_2d) channel-last prediction -> the target layout:
    (N, crop, crop) single-head, (N, num_2d, crop, crop) multi-head."""
    if num_2d == 1:
        return pred[..., 0]
    return torch.movedim(pred, -1, 1)


def _value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of loss_fn(params, *args) -> (loss, aux), with TF32
    off through forward and backward. Leaves without a path to the loss
    (BatchNorm running statistics) get zero gradients, as under jax.grad."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with nn_ops.full_fp32():
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def _sum_metrics(group, metrics: dict) -> dict:
    """0-d metrics summed over the group's ranks in one collective;
    unchanged without a group."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    values = group.sum_(torch.stack([metrics[k].detach() for k in keys]))
    return dict(zip(keys, values.unbind()))


def _reduce(group, grads, metrics: dict):
    """The gradient tree (one flat buffer per dtype) and the metrics summed
    over the group's ranks; unchanged without a group."""
    if group is None:
        return grads, metrics
    return group.sum_tree(grads), _sum_metrics(group, metrics)


def _update(opt, params, opt_state, grads, lr, bn_updates):
    params, opt_state = optim.apply_sgd(opt, params, opt_state, grads, lr)
    bn = BNUpdates()
    bn.updates = bn_updates
    return merge_bn_updates(params, bn), opt_state


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_stage_a_step(cfg: StageAConfig, *, device=None, group=None):
    """Returns (opt, step): step(params, opt_state, seq, target, target_1d,
    rng, lr, normmat_r, eps) -> (params, opt_state, metrics).

    seq: (N, L, 4); target: (N, crop*f, crop*f) raw balanced contacts
    ((N, num_2d, crop*f, crop*f) for multi-head models); target_1d: (N,
    crop, num_1d) binary tracks; normmat_r: (crop, crop) or (num_2d, crop,
    crop). All tensors on `device` (None = CUDA, which must be present);
    rng a key. group: the data-parallel group, None for one process; the
    batch tensors are then this rank's rows.
    """
    resolve_device(device)
    opt = optim.sgd(cfg.momentum)

    def loss_fn(params, seq, target, target_1d, rng, normmat_r, eps):
        bn = BNUpdates(group=group)
        out = decoders.apply_net(
            params, seq, num_1d=cfg.num_1d, num_2d=cfg.num_2d, train=True,
            rng=rng, bn_updates=bn, remat=cfg.remat,
        )
        pred, pred_1d = out if cfg.num_1d else (out, None)
        target_r = losses.downsample_nanmean(target, cfg.crop,
                                             cfg.target_factor)
        tlog = losses.log_fold_target(target_r, normmat_r, eps)
        loss2d = losses.masked_mse(_align_heads(pred, cfg.num_2d), tlog,
                                   group=group)
        loss1d = (losses.bce(pred_1d, target_1d, group=group) if cfg.num_1d
                  else torch.zeros((), device=pred.device))
        return loss2d + loss1d, (bn.updates,
                                 {"loss2d": loss2d, "loss1d": loss1d})

    def step(params, opt_state, seq, target, target_1d, rng, lr, normmat_r,
             eps):
        rng_flip, rng_drop = rng_lib.split(rng, 2)
        # 50% reverse-complement augmentation
        if rng_lib.coin(rng_flip):
            seq = torch.flip(seq, dims=(1, 2))
            target = torch.flip(target, dims=(-2, -1))
            if cfg.num_1d:
                target_1d = torch.flip(target_1d, dims=(1,))
        loss, (bn_updates, metrics), grads = _value_and_grad(
            loss_fn, params, seq, target, target_1d, rng_drop, normmat_r, eps)
        grads, metrics = _reduce(group, grads,
                                 dict(_detached(metrics), loss=loss))
        params, opt_state = _update(opt, params, opt_state, grads, lr,
                                    bn_updates)
        return params, opt_state, metrics

    return opt, step


def stage_a_eval_metrics(params, cfg: StageAConfig, seq, target, target_1d,
                         normmat_r, eps, *, group=None):
    """Validation forward: (pearson r per sample, mse, bce). Unfolded
    parameters are folded first (`fold_params`), so on a CUDA tensor the
    tower runs the fused kernels; the CPU takes their plain versions. With
    a data-parallel group the rows are this rank's: r is theirs, mse and
    bce the global batch's."""
    if "bn" in params["encoder"]["lconv"][0][0]:
        params = fold_params(params, decoders.net_spec(cfg.num_1d,
                                                       cfg.num_2d))
    with torch.no_grad(), nn_ops.full_fp32():
        out = decoders.apply_net(params, seq, num_1d=cfg.num_1d,
                                 num_2d=cfg.num_2d)
        pred, pred_1d = out if cfg.num_1d else (out, None)
        target_r = losses.downsample_nanmean(target, cfg.crop,
                                             cfg.target_factor)
        tlog = losses.log_fold_target(target_r, normmat_r, eps)
        aligned = _align_heads(pred, cfg.num_2d)
        mse = losses.masked_mse(aligned, tlog, group=group)
        n = pred.shape[0]
        corr = torch.stack([losses.pearson_r(a, t) for a, t in zip(
            aligned.reshape(n, -1), tlog.reshape(n, -1))])
        loss1d = (losses.bce(pred_1d, target_1d, group=group) if cfg.num_1d
                  else torch.zeros((), device=pred.device))
        sums = _sum_metrics(group, {"mse": mse, "bce": loss1d})
    return corr, sums["mse"], sums["bce"]


# --------------------------------------------------------------------------
# Stage b: 1-32 Mb (the pyramid + 6 decoders)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageBConfig:
    geometry: CascadeGeometry = GEOM_32M
    levels: Tuple[int, ...] = (32, 16, 8, 4, 2, 1)
    momentum: float = 0.98
    encoder_block_bp: Optional[int] = 800_000
    up_pass: bool = True  # Encoder2 (True) or Encoder2b (HCTnoc variant)
    use_1pt: bool = True  # add the frozen Decoder_1m head at level 1
    upsample_mode: str = "nearest"  # the training decoders' default
    # recompute each trainable decoder block in the backward, keeping only
    # the blocks' inputs (six 28-block decoders' activations otherwise)
    remat: bool = True
    # multi-cell-type heads: one dataset per head; targets and normmats gain
    # a (num_2d,) axis after batch / level
    num_2d: int = 1


def _distenc(normmat_j: torch.Tensor, n: int, crop: int,
             num_2d: int) -> torch.Tensor:
    """Per-level distance encoding -> (N, crop, crop, num_2d) channel-last
    (single-head normmats are (crop, crop), multi-head (num_2d, crop,
    crop))."""
    log_nm = torch.log(normmat_j)
    if log_nm.dim() == 2:
        log_nm = log_nm[None]
    return torch.movedim(log_nm, 0, -1)[None].expand(n, crop, crop, num_2d)


def _slice(x: torch.Tensor, start: int, size: int, dim: int) -> torch.Tensor:
    """x[start:start+size] along `dim`, the start clamped so the slice fits
    (jax.lax.dynamic_slice's rule)."""
    start = min(max(int(start), 0), x.shape[dim] - size)
    return x.narrow(dim, start, size)


def _dynamic_downsample(target: torch.Tensor, start: int, crop: int,
                        factor: int) -> torch.Tensor:
    """NaN-aware block mean of target[..., start:start+crop*f,
    start:start+crop*f]; leading axes pass through."""
    n = crop * factor
    sl = _slice(_slice(target, start, n, -2), start, n, -1)
    return losses.downsample_nanmean(sl, crop, factor)


def _default_encoder_fn(block_bp):
    def encoder_fn(p, s):
        return encoders.apply_encoder_tower(p, s, block_bp=block_bp)
    return encoder_fn


def _frozen_features(encoder_fn, params, seq):
    """The frozen tower under no_grad (the fused kernels on the card)."""
    with torch.no_grad():
        return encoder_fn(params, seq)


def make_stage_b_step(cfg: StageBConfig, encoder_fn=None, *, device=None,
                      group=None):
    """Returns (opt, step): step(trainable, frozen, opt_state, seq, target,
    rng, lr, normmats, epss) -> (trainable, opt_state, metrics).

    trainable = {"pyramid": ..., "decoders": {level: ...}};
    frozen = {"encoder": ..., "decoder_1pt": ...} (folded).
    normmats: (n_levels, crop, crop) stacked coarse to fine; epss:
    (n_levels,). encoder_fn(params, seq) overrides the frozen tower's call.
    All tensors on `device` (None = CUDA, which must be present). group:
    the data-parallel group, None for one process; seq and target are then
    this rank's rows.
    """
    resolve_device(device)
    opt = optim.sgd(cfg.momentum)
    geom = cfg.geometry
    crop, half = geom.crop, geom.half
    encoder_fn = encoder_fn or _default_encoder_fn(cfg.encoder_block_bp)

    def cascade_loss(trainable, frozen, seq, target, rng, normmats, epss):
        bn = BNUpdates(group=group)
        feats = _frozen_features(encoder_fn, frozen["encoder"], seq)
        encs = dict(zip(
            (1, 2, 4, 8, 16, 32),
            encoders.apply_pyramid(
                trainable["pyramid"], feats, levels=5, up_pass=cfg.up_pass,
                train=True, rng=rng, bn_updates=bn, path="pyramid",
            ),
        ))
        rngs = rng_lib.split(rng, len(cfg.levels))
        start = 0
        total = 0.0
        metrics = {}
        coarse = None
        for j, level in enumerate(cfg.levels):
            target_r = _dynamic_downsample(target, start, crop, level)
            distenc = _distenc(normmats[j], seq.shape[0], crop, cfg.num_2d)
            enc_crop = _slice(encs[level], start // level, crop, 1)
            pred = decoders.apply_decoder(
                trainable["decoders"][level], enc_crop, distenc, coarse,
                num_2d=cfg.num_2d, upsample_mode=cfg.upsample_mode,
                train=True, rng=rngs[j], bn_updates=bn,
                path=f"decoders/{level}", remat_blocks=cfg.remat,
            )
            if (level == 1 and cfg.use_1pt
                    and frozen.get("decoder_1pt") is not None):
                # frozen weights, but the gradient reaches the pyramid
                # through this head, as under jax.grad
                pred = pred + decoders.apply_decoder1m(
                    frozen["decoder_1pt"], enc_crop, num_2d=cfg.num_2d)
            tlog = losses.log_fold_target(target_r, normmats[j], epss[j])
            lvl_loss = losses.masked_mse(_align_heads(pred, cfg.num_2d), tlog,
                                         group=group)
            total = total + lvl_loss
            metrics[f"loss_{level}"] = lvl_loss
            # random zoom; the coarse prediction is detached; rngs[j] also
            # seeded this level's dropout (as in the JAX package)
            r = rng_lib.randint(rngs[j], 0, half)
            start = start + r * level
            coarse = pred[:, r:r + half, r:r + half, :].detach()
        return total, (bn.updates, metrics)

    def step(trainable, frozen, opt_state, seq, target, rng, lr, normmats,
             epss):
        loss, (bn_updates, metrics), grads = _value_and_grad(
            cascade_loss, trainable, frozen, seq, target, rng, normmats, epss)
        grads, metrics = _reduce(group, grads,
                                 dict(_detached(metrics), loss=loss))
        trainable, opt_state = _update(opt, trainable, opt_state, grads, lr,
                                       bn_updates)
        return trainable, opt_state, metrics

    return opt, step


def make_stage_b_eval(cfg: StageBConfig, encoder_fn=None, *, device=None,
                      group=None):
    """Validation forward at the reference's fixed zoom offsets (start 0,
    then +(half/2 + 1) * 32, then +half/2 * level), returning per level
    (mse, per-sample pearson r with the >30%-valid gate). device, group: as
    for make_stage_b_step; the mse is the global batch's, r per local
    row."""
    resolve_device(device)
    geom = cfg.geometry
    crop, half = geom.crop, geom.half
    encoder_fn = encoder_fn or _default_encoder_fn(cfg.encoder_block_bp)

    @torch.no_grad()
    def evaluate(trainable, frozen, seq, target, normmats, epss):
        with nn_ops.full_fp32():
            feats = encoder_fn(frozen["encoder"], seq)
            encs = dict(zip(
                (1, 2, 4, 8, 16, 32),
                encoders.apply_pyramid(trainable["pyramid"], feats, levels=5,
                                       up_pass=cfg.up_pass),
            ))
            start = 0
            coarse = None
            mses, corrs = {}, {}
            for j, level in enumerate(cfg.levels):
                target_r = _dynamic_downsample(target, start, crop, level)
                distenc = _distenc(normmats[j], seq.shape[0], crop,
                                   cfg.num_2d)
                enc_crop = _slice(encs[level], start // level, crop, 1)
                pred = decoders.apply_decoder(
                    trainable["decoders"][level], enc_crop, distenc, coarse,
                    num_2d=cfg.num_2d, upsample_mode=cfg.upsample_mode,
                )
                if (level == 1 and cfg.use_1pt
                        and frozen.get("decoder_1pt") is not None):
                    pred = pred + decoders.apply_decoder1m(
                        frozen["decoder_1pt"], enc_crop, num_2d=cfg.num_2d)
                tlog = losses.log_fold_target(target_r, normmats[j], epss[j])
                aligned = _align_heads(pred, cfg.num_2d)
                mses[level] = losses.masked_mse(aligned, tlog, group=group)
                corrs[level] = losses.pearson_r_per_sample(aligned, tlog)
                off = half // 2 + 1 if j == 0 else half // 2
                start = start + off * level
                coarse = pred[:, off:off + half, off:off + half, :]
        return _sum_metrics(group, mses), corrs

    return evaluate


# --------------------------------------------------------------------------
# Stage c: 32-256 Mb (the 256 Mb pyramid + 4 decoders, per-sample normmats)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageCConfig:
    geometry: CascadeGeometry = GEOM_256M
    levels: Tuple[int, ...] = (256, 128, 64, 32)
    momentum: float = 0.98
    encoder_block_bp: Optional[int] = 800_000
    upsample_mode: str = "nearest"
    remat: bool = True  # see StageBConfig.remat


def _nanmin(t: torch.Tensor, group=None) -> torch.Tensor:
    """jnp.nanmin: the least non-NaN entry, NaN if there is none; over the
    global batch with a data-parallel group."""
    nan = torch.isnan(t)
    if group is None and bool(nan.all()):
        return torch.full((), float("nan"), dtype=t.dtype, device=t.device)
    least = torch.where(nan, float("inf"), t).min()
    if group is None:
        return least
    least = group.min_(least)
    return torch.where(torch.isinf(least), float("nan"), least)


def _stage_c_level(geom, j, start, target, normmat, group=None):
    """(factor, target_r, normmat_r, eps) of level j at zoom start; eps is
    the least background entry of the global batch."""
    factor = geom.bins // (geom.crop * 2 ** j)
    target_r = _dynamic_downsample(target, start, geom.crop, factor)
    normmat_r = _dynamic_downsample(normmat, start, geom.crop, factor)
    return factor, target_r, normmat_r, _nanmin(normmat_r, group)


def _stage_c_encodings(trainable, frozen, feats, train=False, **kw):
    with torch.no_grad():
        enc128k = encoders.apply_pyramid(frozen["pyramid1"], feats, levels=5,
                                         up_pass=True)[-1]
    return dict(zip(
        (32, 64, 128, 256),
        encoders.apply_pyramid(trainable["pyramid"], enc128k, levels=3,
                               up_pass=True, train=train, **kw),
    ))


def make_stage_c_step(cfg: StageCConfig, encoder_fn=None, *, device=None,
                      group=None):
    """Returns (opt, step): step(trainable, frozen, opt_state, seq, target,
    normmat, rng, lr) -> (trainable, opt_state, metrics).

    trainable = {"pyramid": ..., "decoders": {level: ...}};
    frozen = {"encoder": ..., "pyramid1": ...} (folded); normmat: (N, bins,
    bins) per-sample background, NaNs filled by the trainer. All tensors on
    `device` (None = CUDA, which must be present). group: as for
    make_stage_b_step.
    """
    resolve_device(device)
    opt = optim.sgd(cfg.momentum)
    geom = cfg.geometry
    crop, half = geom.crop, geom.half
    encoder_fn = encoder_fn or _default_encoder_fn(cfg.encoder_block_bp)

    def cascade_loss(trainable, frozen, seq, target, normmat, rng):
        bn = BNUpdates(group=group)
        feats = _frozen_features(encoder_fn, frozen["encoder"], seq)
        encs = _stage_c_encodings(trainable, frozen, feats, train=True,
                                  rng=rng, bn_updates=bn, path="pyramid")
        rngs = rng_lib.split(rng, len(cfg.levels))
        start = 0
        total = 0.0
        metrics = {}
        coarse = None
        for j, level in enumerate(cfg.levels):
            factor, target_r, normmat_r, eps = _stage_c_level(
                geom, j, start, target, normmat, group)
            distenc = torch.log(normmat_r)[..., None]
            enc_crop = _slice(encs[level], start // factor, crop, 1)
            pred = decoders.apply_decoder(
                trainable["decoders"][level], enc_crop, distenc, coarse,
                upsample_mode=cfg.upsample_mode, train=True, rng=rngs[j],
                bn_updates=bn, path=f"decoders/{level}",
                remat_blocks=cfg.remat,
            )
            tlog = losses.log_fold_target(target_r, normmat_r, eps)
            lvl_loss = losses.masked_mse(pred[..., 0], tlog,
                                         normalize="full_count", group=group)
            total = total + lvl_loss
            metrics[f"loss_{level}"] = lvl_loss
            r = rng_lib.randint(rngs[j], 0, half)
            start = start + r * factor
            coarse = pred[:, r:r + half, r:r + half, :].detach()
        return total, (bn.updates, metrics)

    def step(trainable, frozen, opt_state, seq, target, normmat, rng, lr):
        loss, (bn_updates, metrics), grads = _value_and_grad(
            cascade_loss, trainable, frozen, seq, target, normmat, rng)
        grads, metrics = _reduce(group, grads,
                                 dict(_detached(metrics), loss=loss))
        trainable, opt_state = _update(opt, trainable, opt_state, grads, lr,
                                       bn_updates)
        return trainable, opt_state, metrics

    return opt, step


def make_stage_c_eval(cfg: StageCConfig, encoder_fn=None, *, device=None,
                      group=None):
    """Stage-c validation at the reference's fixed offsets (+half/2 * 32
    after the coarsest level, then +(half/2 + 1) * factor), with per-sample
    background normmats. device, group: as for make_stage_b_eval."""
    resolve_device(device)
    geom = cfg.geometry
    crop, half = geom.crop, geom.half
    encoder_fn = encoder_fn or _default_encoder_fn(cfg.encoder_block_bp)

    @torch.no_grad()
    def evaluate(trainable, frozen, seq, target, normmat):
        with nn_ops.full_fp32():
            feats = encoder_fn(frozen["encoder"], seq)
            encs = _stage_c_encodings(trainable, frozen, feats)
            start = 0
            coarse = None
            mses, corrs = {}, {}
            for j, level in enumerate(cfg.levels):
                factor, target_r, normmat_r, eps = _stage_c_level(
                    geom, j, start, target, normmat, group)
                distenc = torch.log(normmat_r)[..., None]
                enc_crop = _slice(encs[level], start // factor, crop, 1)
                pred = decoders.apply_decoder(
                    trainable["decoders"][level], enc_crop, distenc, coarse,
                    upsample_mode=cfg.upsample_mode,
                )
                tlog = losses.log_fold_target(target_r, normmat_r, eps)
                mses[level] = losses.masked_mse(pred[..., 0], tlog,
                                                normalize="full_count",
                                                group=group)
                corrs[level] = losses.pearson_r_per_sample(pred[..., 0], tlog)
                off = half // 2 if j == 0 else half // 2 + 1
                start = start + off * factor
                coarse = pred[:, off:off + half, off:off + half, :]
        return _sum_metrics(group, mses), corrs

    return evaluate
