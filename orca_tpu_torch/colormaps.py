"""Contact-map colormaps, value-matched to the reference palette (counterpart
of orca_tpu/colormaps.py; matplotlib is imported only inside the functions).

The reference ships two custom colormaps its figures depend on
(the reference's colormaps.py:54-115): `hnh_cmap_ext5`, the default
heatmap palette (a YlOrRd/custom-ramp blend extended into blue for
depleted contacts), and `bwcmap`, a semi-transparent white->black ramp
used to overlay the NaN mask of observed data on predictions
(orca_utils.py:217-221). The numeric stops below are palette *data*
reproduced exactly so plots are visually comparable with published Orca
figures; construction code is ours. tests/test_torch_viz.py holds the
sampled LUTs equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

_CACHE = {}

# 7-stop warm ramp blended 50/50 with matplotlib's YlOrRd
# (colormaps.py:43-60)
_WARM_STOPS = (
    "#fff1d7", "#ffda9d", "#ffb362", "#ff8241", "#ff2b29", "#d60026",
    "#880028",
)
# near-white lead-in block prepended ahead of the warm ramp
# (colormaps.py:62-80): per-channel arithmetic ramps
_EXT_G0, _EXT_G_STEP = 0.97254902, 0.97254902 - 0.97038062
_EXT_B0, _EXT_B_STEP = 0.82156863, 0.82156863 - 0.81618608
# blue extension appended for negative/depleted values (colormaps.py:82-98)
_EXT3_R0, _EXT3_R1, _EXT3_R_STEP = 0.51764706, 0.15294118, (
    0.51764706 - 0.52594939
)
_EXT3_B = 0.15294118
_EXT3_N = 44
_BAD_COLOR = "#AAAAAA"


def _build_hnh_ext3():
    import matplotlib as mpl

    warm = mpl.colors.LinearSegmentedColormap.from_list(
        "orca_tpu_warm",
        [mpl.colors.to_rgba(c) for c in _WARM_STOPS],
        256,
    )
    ylorrd = mpl.colormaps["YlOrRd"]
    x = np.linspace(0.0, 1.0, 256)
    hnh = mpl.colors.LinearSegmentedColormap.from_list(
        "orca_tpu_hnh", 0.5 * warm(x) + 0.5 * ylorrd(x), 256
    )
    lead = np.vstack([
        np.ones(34),
        np.concatenate([np.arange(_EXT_G0, 1, _EXT_G_STEP), np.ones(21)]),
        np.arange(_EXT_B0, 1, _EXT_B_STEP),
        np.ones(34),
    ]).T[::-1, :][:-1, :]
    ext = mpl.colors.LinearSegmentedColormap.from_list(
        "orca_tpu_hnh_ext", np.vstack([lead, hnh(x)])
    )
    blue = np.vstack([
        np.arange(_EXT3_R0, _EXT3_R1, _EXT3_R_STEP),
        np.zeros(_EXT3_N),
        np.ones(_EXT3_N) * _EXT3_B,
        np.ones(_EXT3_N),
    ]).T[1:, :]
    return mpl.colors.LinearSegmentedColormap.from_list(
        "orca_tpu_hnh_ext3", np.vstack([ext(x), blue])
    )


def hnh_cmap_ext5():
    """The reference's default contact-map palette (colormaps.py:105-109):
    hnh_cmap_ext3 resampled at 512 with the first 32 rows dropped."""
    if "ext5" not in _CACHE:
        import matplotlib as mpl

        ext3 = _build_hnh_ext3()
        cmap = mpl.colors.LinearSegmentedColormap.from_list(
            "orca_tpu_hnh_ext5", ext3(np.linspace(0.0, 1.0, 512))[32:, :]
        )
        cmap.set_bad(color=_BAD_COLOR)
        _CACHE["ext5"] = cmap
    return _CACHE["ext5"]


def bwcmap():
    """Semi-transparent white->black overlay ramp (alpha 0 -> 0.2) used to
    shade NaN regions of the observed data onto predictions
    (colormaps.py:111-115; orca_utils.py:217-221)."""
    if "bw" not in _CACHE:
        import matplotlib as mpl

        cmap = mpl.colors.LinearSegmentedColormap.from_list(
            "orca_tpu_bw",
            [mpl.colors.to_rgba("white"), mpl.colors.to_rgba("black")],
            256,
        )
        cmap._init()
        cmap._lut[:, -1] = np.linspace(0, 0.2, cmap.N + 3)
        _CACHE["bw"] = cmap
    return _CACHE["bw"]
