"""The comparison that decides `correct`: a request's answers against the
plain reference's answers to the same request.

An answer is {'maps': [model][level] (crop, crop) arrays, 'starts': [...],
'ends': [...]} and, at 256 Mb, 'backgrounds': [model][level] arrays. The
numbers:

  * map_err: the widest gap of any returned map, over the reference map's
    largest magnitude, the worst map;
  * map_rms_over_bf16: the root-mean-square gap of all of a request's maps
    together over that of the reference's own bfloat16-rounded run
    (`scale`): the gap in units of what bfloat16 rounding does to this
    model, which moves with the seed's weights as much as the gap does;
  * coord_mismatch: start and end coordinates that differ (exact);
  * background_err: as map_err, for the returned backgrounds (256 Mb).

A number that cannot be read (a missing or non-finite answer) is the
largest float. The traffic mix's `limits` name the numbers a cell holds.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

WORST = float(np.finfo(np.float64).max)


def _max_gap(g: np.ndarray, w: np.ndarray) -> float:
    return float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)


def _worst(got, want, gap) -> float:
    worst = 0.0
    if len(got) != len(want):
        return WORST
    for g_model, w_model in zip(got, want):
        if len(g_model) != len(w_model):
            return WORST
        for g, w in zip(g_model, w_model):
            g = np.asarray(g, np.float64)
            w = np.asarray(w, np.float64)
            if g.shape != w.shape or not np.all(np.isfinite(g)):
                return WORST
            worst = max(worst, gap(g, w))
    return worst


def _pooled_rms(got, want) -> float:
    """The root-mean-square gap of all maps together (WORST if unreadable)."""
    if _worst(got, want, _max_gap) == WORST:
        return WORST
    sq = sum(float(np.sum((np.asarray(g, np.float64)
                           - np.asarray(w, np.float64)) ** 2))
             for gm, wm in zip(got, want) for g, w in zip(gm, wm))
    n = sum(np.asarray(w).size for wm in want for w in wm)
    return float(np.sqrt(sq / n))


def numbers(got: dict, want: dict,
            scale: Optional[dict] = None) -> Dict[str, float]:
    out = {"map_err": _worst(got["maps"], want["maps"], _max_gap),
           "coord_mismatch": float(
               sum(a != b for a, b in zip(got["starts"], want["starts"]))
               + sum(a != b for a, b in zip(got["ends"], want["ends"]))
               + abs(len(got["starts"]) - len(want["starts"]))
               + abs(len(got["ends"]) - len(want["ends"])))}
    if scale is not None:
        unit = _pooled_rms(scale["maps"], want["maps"])
        gap = _pooled_rms(got["maps"], want["maps"])
        out["map_rms_over_bf16"] = (WORST if gap == WORST
                                    else gap / max(unit, 1e-30))
    if "backgrounds" in want:
        out["background_err"] = _worst(got.get("backgrounds", []),
                                       want["backgrounds"], _max_gap)
    return out
