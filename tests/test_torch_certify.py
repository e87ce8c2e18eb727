"""The port's fp32 certificate against the JAX package.

Both packages run on the CPU in fp32 on the same seeded parameters and
inputs, at the geometries and zooms of the JAX package's own certificate
(CERTIFY_SYNTH.json), through the entry points a user calls:

- 1m: the 1 Mb `Net` (`decoders.init_net`, 32 tracks) by `apply_net` on a
  1,000,000 bp window of codes from RandomState(seed + 1); the 2D map and
  the 1D head are compared.
- 32m: `genomepredict` at GEOM_32M (32 Mb, 4 kb bins, crop 250) on
  RandomState(seed + 1).rand(1, window, 4), zoomed at window fractions 0.5
  and 0.13 with wpos at the window's middle; all six levels and their
  start coordinates are compared.
- 256m: `genomepredict_256mb` at GEOM_256M with a first chromosome of
  145,120,000 bp (chr8's length in whole 32 kb bins) and its padding, the
  background from `assemble_normmat`, zoomed at chromosome fractions 0.44
  and 0.995 (the clamp at the chromosome's end); all four levels and their
  starts are compared.

The parameters are the JAX package's seeded random bundles (folded) and its
1 Mb `Net`, carried into the port by `models.from_jax`; the normmats are
`zoo._random_normmats`. Every figure is held to max|d| <= 2.0e-6, the bar
the JAX package holds against the original Orca. The families' geometries
and zooms, the 256 Mb sequence and background, and the per-level max|d|
are `orca_tpu_torch.certify_card`'s, which the card certificate
(`test_torch_certify_card.py`) uses too; SMALL here holds the small
geometries both files test at.

The full-geometry runs are `slow`: each writes its family's entry of
CERTIFY_TORCH.json at the repository's root (per-level max|d|, starts
equal, geometry, dtype, seed, bar, each side's seconds on this host, pass)
before it asserts the bar, so a miss is on record. The 256 Mb case needs a
host with ~40 GiB free for the two float32 one-hot windows and their
reverse complements (`-k "not 256m"` leaves it out). The unmarked case runs
the same harness at the smallest geometries that zoom (1.024 Mb, crop 8; a
40 kb Net; 8.192 Mb for 256 Mb, the tower replaced by seeded encodings in
both packages), one zoom per family, and writes its report to a temporary
file.
"""

import json
import pathlib
import resource
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import decoders as jdec
from orca_tpu.predict import multiscale as jms
from orca_tpu_torch import certify_card as cert
from orca_tpu_torch.models.from_jax import bundle_from_numpy, params_from_numpy
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.predict import multiscale as tms

REPORT = pathlib.Path(__file__).resolve().parent.parent / "CERTIFY_TORCH.json"
BAR = cert.BAR_FP32
SEED = cert.SEED


def _seconds(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _figures(entry):
    """The blocks of an entry that hold figures: the entry itself (1m) or
    each of its zooms."""
    return [b for b in [entry, *entry.values()]
            if isinstance(b, dict) and "max_abs_diff" in b]


def _entry(figures, geometry, seconds):
    """A family's report entry: its figures (by zoom, or the 1m family's
    own), then the common keys; `host_peak_rss_gib` is the test process's
    peak resident memory so far (both packages ran in it)."""
    entry = {**figures, "geometry": geometry, "dtype": "float32",
             "seed": SEED, "bar": BAR, "seconds": seconds,
             "host_threads": torch.get_num_threads(),
             "host_peak_rss_gib": resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 2**20}
    entry["pass"] = all(
        max(b["max_abs_diff"].values()) <= BAR and b.get("starts_equal", True)
        for b in _figures(entry))
    return entry


def certify_1m(fam=cert.FULL["1m"]):
    """The 1 Mb Net's map and tracks in both packages."""
    params = jdec.init_net(jax.random.PRNGKey(SEED), num_1d=fam.num_1d)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    codes = np.random.RandomState(SEED + 1).randint(0, 4, size=fam.window_bp)
    seq = np.eye(4, dtype=np.float32)[codes][None]
    (w2, w1), jax_s = _seconds(lambda: [
        np.asarray(a, np.float32) for a in
        jdec.apply_net(params, jnp.asarray(seq), num_1d=fam.num_1d)])
    with torch.inference_mode():
        (g2, g1), port_s = _seconds(lambda: [
            a.float().numpy() for a in
            tdec.apply_net(tparams, torch.from_numpy(seq), num_1d=fam.num_1d)])
    want, got = (cert.Output({"2d": b2[0, :, :, 0], "1d": b1[0]})
                 for b2, b1 in ((w2, w1), (g2, g1)))
    figures = {"max_abs_diff": cert.max_abs_diffs(want, got)}
    return _entry(figures, {"seq_len": fam.window_bp, "num_1d": fam.num_1d},
                  {"orca_tpu": jax_s, "orca_tpu_torch": port_s})


def _compare_levels(got, want, levels):
    got, want = (cert.cascade_output(levels, o) for o in (got, want))
    assert len(got.maps) == len(want.maps) == len(levels)
    return {"max_abs_diff": cert.max_abs_diffs(want, got),
            "starts_equal": got.starts == want.starts}


def _geometry(fam):
    """The family's geometry as the report records it (its inputs here
    have no run of N)."""
    return {k: v for k, v in fam.describe().items() if k != "n_run"}


def certify_32m(fam=cert.FULL["32m"]):
    """`genomepredict` in both packages on the JAX package's folded random
    32 Mb bundle."""
    geom = fam.geometry
    jgeom = jms.CascadeGeometry(geom.window_bp, geom.bin_bp, geom.crop)
    jb = jzoo.fold_bundle(jzoo.random_32m_bundle(SEED, nbins=geom.bins,
                                                 crop=geom.crop))
    tb = bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    seq = np.random.RandomState(SEED + 1).rand(1, geom.window_bp, 4).astype(
        np.float32)
    levels = fam.levels(tb)
    zooms, seconds = {}, {"orca_tpu": 0.0, "orca_tpu_torch": 0.0}
    for zoom, z in fam.zooms().items():
        args = (seq, "chrSynthetic", z["mpos"], z["wpos"])
        want, jax_s = _seconds(lambda: jms.genomepredict(
            *args, [jb], geometry=jgeom))
        got, port_s = _seconds(lambda: tms.genomepredict(
            *args, [tb], geometry=geom, device="cpu"))
        seconds["orca_tpu"] += jax_s
        seconds["orca_tpu_torch"] += port_s
        zooms[zoom] = _compare_levels(got, want, levels)
    return _entry(zooms, _geometry(fam), seconds)


def certify_256m(fam=cert.FULL["256m"]):
    """`genomepredict_256mb` in both packages on the JAX package's folded
    random 256 Mb bundle, a chr8-long first chromosome and its padding."""
    geom = fam.geometry
    jgeom = jms.CascadeGeometry(geom.window_bp, geom.bin_bp, geom.crop)
    jb = jzoo.fold_256m_bundle(jzoo.random_256m_bundle(SEED))
    tb = bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    inp = fam.inputs(jb)
    levels = fam.levels(tb)
    zooms, seconds = {}, {"orca_tpu": 0.0, "orca_tpu_torch": 0.0}
    for zoom, z in fam.zooms().items():
        args = (inp["sequence"], "chrM", [inp["normmat"]], fam.chrlen,
                z["mpos"], z["wpos"])
        want, jax_s = _seconds(lambda: jms.genomepredict_256mb(
            *args, [jb], padding_chr="chrP", geometry=jgeom))
        got, port_s = _seconds(lambda: tms.genomepredict_256mb(
            *args, [tb], padding_chr="chrP", geometry=geom, device="cpu"))
        seconds["orca_tpu"] += jax_s
        seconds["orca_tpu_torch"] += port_s
        zooms[zoom] = _compare_levels(got, want, levels)
    return _entry(zooms, _geometry(fam), seconds)


def estimate_256m(seconds, window_bp, n_zooms):
    """Seconds per Mb of window and zoom of a run of `window_bp` at
    `n_zooms` zooms, and at that rate the 256 Mb family's seconds at its
    full geometry and zooms."""
    per_mb = seconds / (window_bp / 1e6 * n_zooms)
    fam = cert.FULL["256m"]
    return per_mb, per_mb * fam.window_bp / 1e6 * len(fam.zooms())


def not_run_256m(entry_32m):
    """The 256 Mb entry while it has not run at full geometry: its geometry
    and zooms, and its cost estimated from the 32 Mb run's seconds per Mb of
    window and zoom on this host."""
    fam = cert.FULL["256m"]
    est = {side: estimate_256m(s, entry_32m["geometry"]["window_bp"],
                               len(_figures(entry_32m)))
           for side, s in entry_32m["seconds"].items()}
    return {
        "not_run": "a 256 Mb window through both packages on the CPU takes "
                   "8x a 32 Mb window's time per zoom (estimated_seconds) "
                   "and holds 8.2 GB of float32 forward and reverse "
                   "windows; the port's card path is certified against "
                   "orca_tpu at this geometry instead (the card block, from "
                   "chip_smoke.py's certify_card line against "
                   "tests/data/certify_card_ref.npz)",
        "geometry": fam.describe(),
        "zooms": list(fam.zooms()),
        "seconds_per_Mb": {side: e[0] for side, e in est.items()},
        "estimated_seconds": {side: e[1] for side, e in est.items()},
        "dtype": "float32", "seed": SEED, "bar": BAR, "pass": None,
    }


def write_entry(path, family, entry):
    """Merge `family`'s entry into the report at `path`; `pass` is every
    certified family's. A 32 Mb entry also (re)estimates a 256 Mb entry
    that has not run."""
    report = json.loads(path.read_text()) if path.exists() else {}
    report[family] = entry
    if family == "32m" and "not_run" in report.get("256m", {"not_run": 1}):
        report["256m"] = not_run_256m(entry)
    report.pop("pass", None)
    report["pass"] = all(v["pass"] for v in report.values()
                         if "not_run" not in v)
    path.write_text(json.dumps(report, indent=2) + "\n")
    return report


def assert_certified(entry):
    for block in _figures(entry):
        for level, d in block["max_abs_diff"].items():
            assert d <= BAR, f"level {level}: max|d| {d:.4e}"
        assert block.get("starts_equal", True), "starts differ"
    assert entry["pass"]


def _seeded_encodings_256m(monkeypatch, geom):
    """Both packages' 256 Mb encoder step gives the same seeded fwd+RC
    encodings (the bp tower at 8.192 Mb is too slow for the fast gate)."""
    rng = np.random.RandomState(SEED + 5)
    encs = {lv: rng.randn(2, geom.window_bp // (4000 * lv), 128)
            .astype(np.float32) for lv in jzoo.LEVELS_256M}
    monkeypatch.setattr(
        jms, "_encode_256mb_jit",
        lambda bundle, geom, seq, mesh=None: tuple(
            jnp.asarray(encs[lv]) for lv in jzoo.LEVELS_256M))
    monkeypatch.setattr(
        tms, "_encode_256mb_fwd_rc",
        lambda bundle, seq, mesh=None: {
            lv: torch.from_numpy(encs[lv]) for lv in jzoo.LEVELS_256M})


# the smallest geometries that zoom, one zoom each; the 32 Mb family's run
# of N is for the card certificate's inputs (this harness draws its own)
SMALL = {
    "1m": cert.Net1M("1m", 40_000),
    "32m": cert.Cascade32M("32m", 1_024_000, crop=8, fracs=(0.13,),
                           n_run=(100_000, 150_000)),
    "256m": cert.Cascade256M("256m", 8_192_000, crop=8, fracs=(0.995,)),
}
CERTIFY = {"1m": certify_1m, "32m": certify_32m, "256m": certify_256m}
KEYS = {"geometry", "dtype", "seed", "bar", "seconds", "host_threads",
        "host_peak_rss_gib", "pass"}


@pytest.mark.parametrize("family", sorted(SMALL))
def test_certify_harness_small(family, monkeypatch, tmp_path):
    """The harness at the smallest geometries that zoom: the bundle carried
    across, both packages' entry points, the report's keys and the bar."""
    if family == "256m":
        _seeded_encodings_256m(monkeypatch, SMALL[family].geometry)
    entry = CERTIFY[family](SMALL[family])
    path = tmp_path / "certify.json"
    report = write_entry(path, family, entry)
    assert json.loads(path.read_text()) == report
    assert KEYS <= set(entry) and report["pass"] == entry["pass"]
    assert _figures(entry) and all(b["max_abs_diff"]
                                   for b in _figures(entry))
    assert entry["dtype"] == "float32" and entry["bar"] == BAR
    assert all(s > 0 for s in entry["seconds"].values())
    assert_certified(entry)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["1m", "32m", "256m"])
def test_certify_full_geometry(family):
    """The certificate at CERTIFY_SYNTH.json's full geometries: the family's
    entry goes into CERTIFY_TORCH.json, then each figure is held to the
    bar."""
    entry = CERTIFY[family](cert.FULL[family])
    write_entry(REPORT, family, entry)
    assert_certified(entry)
