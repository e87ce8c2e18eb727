"""Adaptive coarse-graining of balanced Hi-C matrices (vectorized numpy).

Framework equivalent of the reference's pure-tensor cooltools port
(selene_utils2.py:274-463) and its non-square wrapper (:466-504). Algorithm:
pad to a power of two, build 2x2-sum pyramids of (values, raw counts, valid
mask), then walk back down replacing any 2x2 neighborhood whose minimum raw
count over valid pixels is below `cutoff` with the coarser NaN-aware
average. Host-side preprocessing — runs in the input pipeline, not on the
device.
"""

from __future__ import annotations

import numpy as np


def _coarsen_sum(a: np.ndarray) -> np.ndarray:
    m = a.shape[0] // 2
    return a.reshape(m, 2, m, 2).sum(axis=(1, 3))


def _coarsen_min_nan(a: np.ndarray) -> np.ndarray:
    m = a.shape[0] // 2
    return np.nan_to_num(a, nan=np.inf).reshape(m, 2, m, 2).min(axis=(1, 3))


def _expand(a: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)


def adaptive_coarsegrain(ar: np.ndarray, countar: np.ndarray, cutoff: float = 5,
                         max_levels: int = 8, min_shape: int = 8) -> np.ndarray:
    """Smooth low-count pixels of a balanced matrix using the count pyramid.

    ar: (n, n) balanced matrix (NaN = invalid); countar: (n, n) raw counts.
    Returns the smoothed (n, n) matrix with NaN at invalid pixels.
    """
    ar = np.asarray(ar, dtype=np.float64)
    countar = np.asarray(countar, dtype=np.float64)
    n_orig = ar.shape[0]
    nlog = np.log2(n_orig)
    if not np.allclose(nlog, np.rint(nlog)):
        n_new = int(2 ** np.ceil(nlog))
        ar_p = np.full((n_new, n_new), np.nan)
        cnt_p = np.zeros((n_new, n_new))
        ar_p[:n_orig, :n_orig] = ar
        cnt_p[:n_orig, :n_orig] = countar
        ar, countar = ar_p, cnt_p

    mask = np.isfinite(ar)
    ar = np.where(mask, ar, 0.0)
    countar = np.where(mask, countar, 0.0)

    ars = [ar]
    counts = [countar]
    masks = [mask.astype(np.float64)]
    for _ in range(max_levels):
        if counts[-1].shape[0] > min_shape:
            counts.append(_coarsen_sum(counts[-1]))
            masks.append(_coarsen_sum(masks[-1]))
            ars.append(_coarsen_sum(ars[-1]))

    ar_cur = ars.pop()
    counts.pop()
    mask_cur = masks.pop()

    ar_next = ar_cur
    mask_next = mask_cur
    for _ in range(len(counts)):
        ar_next = ars.pop()
        count_next = counts.pop()
        mask_next = masks.pop()

        with np.errstate(invalid="ignore", divide="ignore"):
            val_cur = ar_cur / mask_cur
        val_exp = _expand(val_cur)
        addar_exp = val_exp * mask_next

        count_exp = _expand(_coarsen_min_nan(count_next))
        replace = count_exp < cutoff
        ar_next = np.where(replace, addar_exp, ar_next)
        ar_next = np.where(mask_next == 0, 0.0, ar_next)

        ar_cur = ar_next
        mask_cur = mask_next

    out = np.where(mask_next == 0, np.nan, ar_next)
    return out[:n_orig, :n_orig]


def adaptive_coarsegrain_any(ar: np.ndarray, countar: np.ndarray,
                             max_levels: int = 12) -> np.ndarray:
    """Non-square/small-input wrapper: NaN-pad to square (interchromosomal
    queries), smooth, crop back (selene_utils2.py:466-504)."""
    ar = np.asarray(ar, dtype=np.float64)
    countar = np.asarray(countar, dtype=np.float64)
    assert ar.shape == countar.shape
    h, w = ar.shape
    if h < 9 and w < 9:
        ar_p = np.full((9, 9), np.nan)
        cnt_p = np.full((9, 9), np.nan)
        ar_p[:h, :w] = ar
        cnt_p[:h, :w] = countar
        return adaptive_coarsegrain(ar_p, cnt_p, max_levels=max_levels)[:h, :w]
    if h == w:
        return adaptive_coarsegrain(ar, countar, max_levels=max_levels)
    n = max(h, w)
    ar_p = np.full((n, n), np.nan)
    cnt_p = np.full((n, n), np.nan)
    ar_p[:h, :w] = ar
    cnt_p[:h, :w] = countar
    return adaptive_coarsegrain(ar_p, cnt_p, max_levels=max_levels)[:h, :w]
