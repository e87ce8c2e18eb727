"""Distance-expectation preprocessing (counterpart of
orca_tpu/data/expectation.py, a port of misc/process_expectation.py).

Converts `cooltools compute-expected` style per-diagonal statistics into the
framework's expectation files: the log cis expectation curve (two-scale
lowess smoothing), its monotonic variant (np.minimum.accumulate), and the
scalar log trans expectation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _lowess(y: np.ndarray, x: np.ndarray, frac: float) -> np.ndarray:
    """Lowess smoother; uses statsmodels when present, otherwise a local
    linear-regression fallback with tricube weights (same model class)."""
    try:
        from statsmodels.nonparametric.smoothers_lowess import lowess

        return lowess(y, x, frac=frac)[:, 1]
    except ImportError:
        n = len(x)
        k = max(int(np.ceil(frac * n)), 2)
        out = np.empty(n)
        order = np.argsort(x)
        xs, ys = x[order], y[order]
        for i in range(n):
            d = np.abs(xs - xs[i])
            idx = np.argpartition(d, k - 1)[:k]
            dmax = d[idx].max() or 1.0
            w = (1 - (d[idx] / dmax) ** 3) ** 3
            xi, yi = xs[idx], ys[idx]
            sw = w.sum()
            mx, my = (w * xi).sum() / sw, (w * yi).sum() / sw
            vx = (w * (xi - mx) ** 2).sum()
            slope = ((w * (xi - mx) * (yi - my)).sum() / vx) if vx > 0 else 0.0
            out[i] = my + slope * (xs[i] - mx)
        inv = np.empty(n, dtype=int)
        inv[order] = np.arange(n)
        return out[inv]


def expectation_from_diagonals(
    balanced_sum: np.ndarray,
    n_valid: np.ndarray,
    res: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-diagonal sums -> smoothed log expectation (+ monotonic variant).

    Mirrors misc/process_expectation.py:19-45: log of the per-diagonal
    balanced average truncated at the first non-finite value, kept raw below
    ~400 bins (at 4kb-equivalent), lowess frac=0.01 up to ~10k bins, 0.1
    beyond, then np.minimum.accumulate for the monotonic curve.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.log(balanced_sum / n_valid)
    bad = np.argwhere(~np.isfinite(v))
    if len(bad):
        v = v[: int(bad.min())]
    lo = int(400 / (res / 4000))
    hi = int(10000 / (res / 4000))
    if len(v) <= lo:
        return v, np.minimum.accumulate(v)
    logx = np.log(np.arange(lo, len(v)) + 1)
    sv0 = _lowess(v[lo:], logx, frac=0.01)
    sv2 = _lowess(v[lo:], logx, frac=0.1)
    sv = np.hstack([v[:lo], sv0[:hi], sv2[hi:]])
    return sv, np.minimum.accumulate(sv)


def trans_expectation(balanced_sum_trans: np.ndarray,
                      n_valid_trans: np.ndarray) -> float:
    """Scalar log trans expectation (misc/process_expectation.py:47-53)."""
    return float(np.log(np.sum(balanced_sum_trans) / np.sum(n_valid_trans)))


def diagonal_stats_from_cooler(uri: str):
    """Per-diagonal (n_valid, balanced.sum) + trans totals straight from a
    cooler/mcool via the in-repo h5py reader — the stats `cooltools
    compute-expected` produces, without the cooltools dependency.

    n_valid[d] counts ALL bin pairs at separation d whose balancing
    weights are both finite (cooltools semantics — not just nonzero
    pixels), computed per chromosome via FFT autocorrelation of the
    validity mask; balanced sums accumulate count*w_i*w_j per diagonal
    from the CSR pixel slabs.
    """
    from orca_tpu_torch.data.mcool import NativeCooler

    c = NativeCooler(uri)
    root = c._root()
    chrom_offset = np.asarray(root["indexes"]["chrom_offset"][:], np.int64)
    w = c.weights()
    valid = np.isfinite(w)

    nbins_max = int(np.max(np.diff(chrom_offset)))
    n_valid = np.zeros(nbins_max, np.float64)
    balanced = np.zeros(nbins_max, np.float64)

    # per-chromosome valid-pair counts: autocorrelation of the mask
    for ci in range(len(chrom_offset) - 1):
        v = valid[chrom_offset[ci] : chrom_offset[ci + 1]].astype(np.float64)
        n = len(v)
        if n == 0:
            continue
        m = 1 << (2 * n - 1).bit_length()
        f = np.fft.rfft(v, m)
        corr = np.fft.irfft(f * np.conj(f), m)[:n]
        n_valid[:n] += np.round(corr)

    # balanced per-diagonal sums from the pixels (cis); trans totals
    b1off = root["indexes"]["bin1_offset"]
    px = root["pixels"]
    trans_sum = 0.0
    chrom_of = np.searchsorted(chrom_offset, np.arange(len(w)),
                               side="right") - 1
    lo, hi = 0, int(b1off[len(w)])
    step = 4_000_000  # pixel-slab streaming
    for s in range(lo, hi, step):
        e = min(s + step, hi)
        bin1 = np.asarray(px["bin1_id"][s:e], np.int64)
        bin2 = np.asarray(px["bin2_id"][s:e], np.int64)
        cnt = np.asarray(px["count"][s:e], np.float64)
        bal = cnt * w[bin1] * w[bin2]
        ok = np.isfinite(bal)
        cis = ok & (chrom_of[bin1] == chrom_of[bin2])
        d = bin2[cis] - bin1[cis]
        np.add.at(balanced, d, bal[cis])
        tr = ok & ~cis
        # off-diagonal storage is upper-triangular: each trans pixel
        # represents one (i, j) pair
        trans_sum += float(bal[tr].sum())

    # total valid trans pairs: all-pairs minus the cis pairs
    tot_valid = float(valid.sum())
    cis_pairs = 0.0
    for ci in range(len(chrom_offset) - 1):
        nv = float(valid[chrom_offset[ci] : chrom_offset[ci + 1]].sum())
        cis_pairs += nv * (nv + 1) / 2  # incl. the diagonal
    trans_pairs = tot_valid * (tot_valid + 1) / 2 - cis_pairs
    return n_valid, balanced, trans_sum, trans_pairs


def process_expectation_cooler(uri: str, out_prefix: str):
    """Cooler/mcool -> expectation files (.npy/.mono.npy/.trans.npy), the
    end-to-end equivalent of cooltools compute-expected +
    misc/process_expectation.py in one step."""
    from orca_tpu_torch.data.mcool import NativeCooler

    n_valid, balanced, trans_sum, trans_pairs = diagonal_stats_from_cooler(
        uri
    )
    res = NativeCooler(uri).binsize
    sv, sv_mono = expectation_from_diagonals(balanced, n_valid, res)
    written = [out_prefix + ".npy", out_prefix + ".mono.npy"]
    np.save(written[0], sv)
    np.save(written[1], sv_mono)
    if trans_pairs > 0:
        # single-chromosome coolers have no trans pairs -> no .trans.npy
        written.append(out_prefix + ".trans.npy")
        np.save(written[2], np.log(trans_sum / trans_pairs))
    return sv, sv_mono, written


def process_expectation_tsv(path: str, res: int, out_prefix: Optional[str] = None):
    """Full port of the misc/process_expectation.py CLI: read the cooltools
    TSV (columns diag, n_valid, balanced.sum), write .npy/.mono.npy (and
    .trans.npy if `<path>.trans` exists)."""
    import csv

    diags = {}
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            d = int(float(row["diag"]))
            nv = float(row["n_valid"] or 0)
            bs = float(row["balanced.sum"] or 0)
            acc = diags.setdefault(d, [0.0, 0.0])
            acc[0] += nv
            acc[1] += bs
    dmax = max(diags) + 1
    n_valid = np.zeros(dmax)
    balanced = np.zeros(dmax)
    for d, (nv, bs) in diags.items():
        n_valid[d] = nv
        balanced[d] = bs
    sv, sv_mono = expectation_from_diagonals(balanced, n_valid, res)
    out_prefix = out_prefix or path
    np.save(out_prefix + ".npy", sv)
    np.save(out_prefix + ".mono.npy", sv_mono)
    import os

    if os.path.exists(path + ".trans"):
        nv_t, bs_t = [], []
        with open(path + ".trans") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for row in reader:
                nv_t.append(float(row["n_valid"] or 0))
                bs_t.append(float(row["balanced.sum"] or 0))
        np.save(out_prefix + ".trans.npy",
                trans_expectation(np.array(bs_t), np.array(nv_t)))
    return sv, sv_mono
