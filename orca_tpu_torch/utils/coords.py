"""Coordinate helpers (reference orca_utils.py:1009-1060)."""

from __future__ import annotations

import numpy as np


def coord_clip(pos: int, chrlen: int, binsize: int = 128000,
               window_radius: int = 16000000) -> int:
    """Clip `pos` so a window of `window_radius` around it fits in the
    chromosome, preserving the position modulo the `binsize` grid when
    possible (orca_utils.py:1009-1041)."""
    if pos < binsize or pos > chrlen - binsize:
        return int(np.clip(pos, window_radius, chrlen - window_radius))
    if (chrlen - window_radius) % binsize > pos % binsize:
        endclip = (
            chrlen - window_radius
            - ((chrlen - window_radius) % binsize - pos % binsize)
        )
    else:
        endclip = (
            chrlen - window_radius - binsize
            - ((chrlen - window_radius) % binsize - pos % binsize)
        )
    return int(np.clip(pos, window_radius + pos % binsize, endclip))


def coord_round(x: int, gridsize: int = 4000) -> int:
    """Round down to a multiple of gridsize (orca_utils.py:1044-1060)."""
    return x - x % gridsize
