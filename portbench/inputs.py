"""Inputs drawn from the run's seed: the pool of sequence that requests cut
their windows from, the expected-contact curves behind the backgrounds, and
the 256 Mb region-mosaic backgrounds.

Every seed gives the same sizes: only values and the order of draws move.
"""

from __future__ import annotations

import numpy as np
import torch

POOL_CHUNK_BP = 32_000_000


def sequence_pool(seed: int, pool_bp: int, n_fraction: float, n_run_bp,
                  device) -> np.ndarray:
    """(pool_bp, 4) packed quarter-scale one-hot (uint8: 4 on the base's
    channel, 1 on all four at an N), random bases drawn on `device` in
    chunks, with N runs of uniform length in `n_run_bp` covering about
    `n_fraction` of it; fetched to host memory once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    runs = []
    covered = 0
    while covered < n_fraction * pool_bp:
        length = int(rng.integers(n_run_bp[0], n_run_bp[1] + 1))
        start = int(rng.integers(0, pool_bp - length))
        runs.append((start, start + length))
        covered += length
    pool = np.empty((pool_bp, 4), np.uint8)
    channels = torch.arange(4, device=device, dtype=torch.uint8)
    for a in range(0, pool_bp, POOL_CHUNK_BP):
        b = min(pool_bp, a + POOL_CHUNK_BP)
        bases = torch.randint(0, 4, (b - a,), generator=gen, device=device,
                              dtype=torch.uint8)
        chunk = (bases[:, None] == channels[None]).to(torch.uint8) * 4
        for s, e in runs:
            if s < b and e > a:
                chunk[max(s, a) - a:min(e, b) - a] = 1
        pool[a:b] = chunk.cpu().numpy()
    return pool


def expected_log_32m(rng: np.random.Generator, nbins: int) -> np.ndarray:
    """A log expected-contact curve over `nbins` 4 kb distances: a power-law
    decay of drawn slope and offset."""
    slope, offset = 1.0 + 0.5 * rng.random(), 1.5 + rng.random()
    return -slope * np.log1p(np.arange(nbins, dtype=np.float64)) - offset


def background_256m(rng: np.random.Generator, finite_bins: int,
                    total_bins: int):
    """(cis, trans): exp of a drawn log-decay over 32 kb distances, finite
    for `finite_bins` and NaN beyond (as a curve fitted where pairs were
    seen), and the scalar trans expectation."""
    slope, offset = 0.9 + 0.5 * rng.random(), 2.5 + rng.random()
    d = np.arange(finite_bins, dtype=np.float64)
    cis = np.hstack([np.exp(-slope * np.log1p(d) - offset),
                     np.full(total_bins - finite_bins, np.nan)])
    return cis, float(np.exp(-9.0 - rng.random()))


def mosaic_background(regions, cis: np.ndarray, trans: float,
                      bin_bp: int) -> np.ndarray:
    """The background over a mosaic of regions (chrom, start, end): cis
    blocks look the 1D expectation up by bin distance, trans blocks take the
    trans expectation (float64, as the screens hand it over)."""
    rows = []
    for chrom, start, end in regions:
        a = start + bin_bp * np.arange((end - start) // bin_bp)
        row = []
        for chrom2, start2, end2 in regions:
            b = start2 + bin_bp * np.arange((end2 - start2) // bin_bp)
            if chrom2 != chrom:
                row.append(np.full((len(a), len(b)), trans))
            else:
                row.append(cis[np.abs(a[:, None] - b[None, :]) // bin_bp])
        rows.append(np.hstack(row))
    return np.vstack(rows)
