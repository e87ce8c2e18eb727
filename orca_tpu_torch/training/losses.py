"""Training losses (counterpart of orca_tpu/training/losses.py):
distance-normalized masked MSE and the auxiliary BCE.

The 2D loss is the MSE between the prediction and log((target + eps) /
(normmat + eps)) over non-NaN entries: the mean over valid entries in stages
a and b, the sum over N * crop^2 in stage c. The 1D auxiliary loss is BCE on
sigmoid chromatin-track outputs.
"""

from __future__ import annotations

import torch


def downsample_nanmean(target: torch.Tensor, crop: int,
                       factor: int) -> torch.Tensor:
    """(..., crop*factor, crop*factor) -> (..., crop, crop) NaN-aware block
    mean. Leading axes (batch, multi-head datasets) pass through."""
    lead = target.shape[:-2]
    r = target.reshape(*lead, crop, factor, crop, factor)
    valid = torch.isfinite(r)
    s = torch.where(valid, r, 0.0).sum(dim=(-3, -1))
    c = valid.sum(dim=(-3, -1))
    return torch.where(c > 0, s / c.clamp_min(1), float("nan"))


def log_fold_target(target_r: torch.Tensor, normmat, eps) -> torch.Tensor:
    """log fold over the distance background; NaNs propagate."""
    return torch.log((target_r + eps) / (normmat + eps))


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               normalize: str = "valid_mean", group=None) -> torch.Tensor:
    """MSE over finite target entries: 'valid_mean' divides by their count
    (stages a and b), 'full_count' by every entry (stage c).

    group: a parallel.multihost.DataGroup whose ranks hold equal shares of
    the batch. The sum stays this rank's and the count is the global batch's
    (all-reduced, outside autograd), so the ranks' losses and gradients sum
    to the one-process step's; a mean of per-rank means would not equal it
    where the ranks hold different NaN counts."""
    mask = torch.isfinite(target)
    sq = torch.where(mask, (pred - torch.where(mask, target, 0.0)) ** 2, 0.0)
    if normalize == "valid_mean":
        count = mask.sum()
        if group is not None:
            count = group.sum_(count)
        return sq.sum() / count.clamp_min(1)
    return sq.sum() / (pred.numel() * (group.world if group else 1))


def bce(pred: torch.Tensor, target: torch.Tensor,
        eps: float = 1e-7, group=None) -> torch.Tensor:
    """Binary cross-entropy on probabilities (nn.BCELoss semantics), clamped
    for numerical safety. group: as for masked_mse, over the global
    batch's entries."""
    p = pred.clamp(eps, 1 - eps)
    terms = -(target * torch.log(p) + (1 - target) * torch.log1p(-p))
    if group is None:
        return terms.mean()
    return terms.sum() / (terms.numel() * group.world)


def pearson_r_per_sample(pred: torch.Tensor, target: torch.Tensor,
                         min_valid: float = 0.3) -> torch.Tensor:
    """Per-sample Pearson r over finite target entries; NaN where no more
    than `min_valid` of the entries are valid (the validation metric)."""
    n = pred.shape[0]
    p = pred.reshape(n, -1)
    t = target.reshape(n, -1)
    valid = torch.isfinite(t)
    cnt = valid.sum(dim=1).clamp_min(1)
    tz = torch.where(valid, t, 0.0)
    pz = torch.where(valid, p, 0.0)
    mp = pz.sum(dim=1) / cnt
    mt = tz.sum(dim=1) / cnt
    dp = torch.where(valid, p - mp[:, None], 0.0)
    dt = torch.where(valid, t - mt[:, None], 0.0)
    cov = (dp * dt).sum(dim=1)
    denom = torch.sqrt((dp ** 2).sum(dim=1) * (dt ** 2).sum(dim=1))
    r = cov / denom.clamp_min(1e-12)
    frac = valid.sum(dim=1) / t.shape[1]
    return torch.where(frac > min_valid, r, float("nan"))


def pearson_r(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over finite target entries (stage-a validation)."""
    mask = torch.isfinite(target)
    n = mask.sum().clamp_min(1)
    t = torch.where(mask, target, 0.0)
    p = torch.where(mask, pred, 0.0)
    mp = p.sum() / n
    mt = t.sum() / n
    vp = torch.where(mask, p - mp, 0.0)
    vt = torch.where(mask, t - mt, 0.0)
    cov = (vp * vt).sum()
    denom = torch.sqrt((vp ** 2).sum() * (vt ** 2).sum())
    return cov / denom.clamp_min(1e-12)
