"""The reference that holds the port's card path to orca_tpu at full
geometry, and the comparison the card runs against it.

`tests/data/certify_card_ref.npz` holds orca_tpu's outputs on the CPU for
the families of `orca_tpu_torch.certify_card` (1 Mb `predict_1m` with its
tracks; 32 Mb `genomepredict` at both zooms; 256 Mb `genomepredict_256mb`
at both zooms) in float32, and for 32 Mb in bfloat16 too, with orca_tpu's
own bf16-vs-fp32 max|d| at each level, on the port's seeded random bundles
(drawn and folded on the CPU by the port, carried into orca_tpu's bundle
classes by `bundle_to_jax`, the inverse of `models.from_jax.
bundle_from_numpy`) and numpy-seeded inputs, with the SHA-256 digests of
both. `chip_smoke.py` regenerates the weights and inputs on the card's host,
checks the digests, and holds the card's outputs to it.

The `slow` case regenerates each family's entry from orca_tpu and requires
it to equal the committed file: every array bit for bit, the starts, the
digests, the geometry and orca_tpu's own bf16-vs-fp32 figures (its seconds,
commit and versions are not compared). Where the file has no entry for the
family, or ORCA_CERTIFY_CARD_WRITE=1, it writes the entry instead:

    pytest -m slow tests/test_torch_certify_card.py            # check
    ORCA_CERTIFY_CARD_WRITE=1 pytest -m slow tests/test_torch_certify_card.py

The unmarked cases check the committed file's layout and digests against
the port's current init, the inverse converter, and the comparison itself
on the CPU plain path at the small geometries of `test_torch_certify.py`'s
harness against a reference the same generator writes, doctored copies of
it included.
"""

import dataclasses
import hashlib
import os
import pathlib
import subprocess

import jax
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import encoders as jenc
from orca_tpu.predict import multiscale as jms
from orca_tpu.predict import onemb as jonemb
from orca_tpu.predict.retrieval import assemble_normmat
from orca_tpu_torch import certify_card as cert
from orca_tpu_torch.models import zoo
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from test_torch_certify import (SMALL, _seconds, _seeded_encodings_256m,
                                estimate_256m)

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = REPO / "tests" / "data" / "certify_card_ref.npz"
MAX_BYTES = 5_000_000
# the dtypes each family's reference holds; the 256 Mb bf16 entry is
# not_run (NOT_RUN_BF16_256M's estimate)
DTYPES = {"1m": ("float32",), "32m": ("float32", "bfloat16"),
          "256m": ("float32",)}
NOT_RUN_BF16_256M = (
    "orca_tpu in bfloat16 on XLA:CPU, which has no native bf16 "
    "convolutions: a 256 Mb window at both zooms would take "
    "estimated_seconds on the host that made this file (the 32 Mb bf16 "
    "seconds per Mb of window and zoom, times 256 Mb and two zooms), over "
    "the 30 minutes allowed")

# orca_tpu's bf16 tower on XLA:CPU at its default group (16 Mb of sequence
# a scan step) asks for 118 GB at 32 Mb: the reference's bf16 requests run
# it BF16_ROWS rows (800 kb blocks with their 112 kb halos) a scan step
# through the package's own group cap, `_default_block_group`, which bounds
# the activations in flight and not what the tower computes
BF16_ROWS = 2

# XLA:CPU's outputs depend on the instruction set it compiles for: on a
# host whose CPU differs from the header's, a regenerated array is held to
# SPREAD[dtype] instead of bit equality. Regenerated on the file's own host
# with XLA capped to SSE4.2 (`XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 pytest -m
# slow -s -k "1m or 32m"` prints each level's max|d|), float32
# moved by up to 1.192e-6 (32 Mb, level 2; 1 Mb 1.19e-7) and bfloat16 not
# at all; capped to AVX2 nothing moved. Both dtypes are held to twice the
# largest figure.
SPREAD = {"float32": 2 * 1.192e-6, "bfloat16": 2 * 1.192e-6}

JAX_CLASS = {
    zoo.ModelBundle: jzoo.ModelBundle,
    zoo.Model256MBundle: jzoo.Model256MBundle,
    zoo.Model1MBundle: jzoo.Model1MBundle,
}


def bundle_to_jax(bundle):
    """The port's bundle (any class) -> orca_tpu's class of the same kind
    with the same numpy leaves: the inverse of `bundle_from_numpy`."""
    host = zoo._map_params(bundle, lambda t: t.detach().cpu().numpy())
    cls = JAX_CLASS[type(bundle)]
    return cls(**{f.name: getattr(host, f.name)
                  for f in dataclasses.fields(cls)})


def _jax_1m(fam, jb, inp, zoom):
    pred, tracks = jonemb.predict_1m(jb, inp["sequence"], with_1d=True)
    return cert.Output({"2d": np.asarray(pred[0, :, :, 0], np.float32),
                        "1d": np.asarray(tracks[0], np.float32)})


def _jax_32m(fam, jb, inp, zoom):
    z = fam.zooms()[zoom]
    return cert.cascade_output(fam.levels(jb), jms.genomepredict(
        inp["sequence"], "chrSynthetic", z["mpos"], z["wpos"], [jb],
        geometry=_jax_geometry(fam)))


def _jax_256m(fam, jb, inp, zoom):
    z = fam.zooms()[zoom]
    return cert.cascade_output(fam.levels(jb), jms.genomepredict_256mb(
        inp["sequence"], "chrM", [inp["normmat"]], fam.chrlen, z["mpos"],
        z["wpos"], [jb], padding_chr="chrP", geometry=_jax_geometry(fam)))


def _jax_geometry(fam):
    return jms.CascadeGeometry(fam.window_bp, fam.bin_bp, fam.crop)


RUN_JAX = {cert.Net1M: _jax_1m, cert.Cascade32M: _jax_32m,
           cert.Cascade256M: _jax_256m}


def run_jax(fam, jb, inp, zoom):
    """One request through orca_tpu's entry point, as `fam.run` in the
    port."""
    return RUN_JAX[type(fam)](fam, jb, inp, zoom)


def _commit():
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def host():
    """The CPU XLA:CPU compiles for (its model name and a digest of its
    feature flags, from the first processor of /proc/cpuinfo) and the
    threads this process may use."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    fields = {}
    for line in text.split("\n\n", 1)[0].splitlines():
        k, _, v = line.partition(":")
        fields[k.strip()] = v.strip()
    flags = " ".join(sorted(set(fields.get("flags", "").split())))
    return {"cpu": fields.get("model name"),
            "cpu_flags_sha256": hashlib.sha256(flags.encode()).hexdigest(),
            "threads": len(os.sched_getaffinity(0))}


def generate(fam, dtypes):
    """`fam`'s header entry and outputs ({key: Output}) from orca_tpu on the
    CPU."""
    bundle = fam.weights()
    inp = fam.inputs(bundle)
    if isinstance(fam, cert.Cascade256M):
        # the background orca_tpu's own retrieval would assemble
        assert np.array_equal(inp["normmat"], assemble_normmat(
            fam.regions(), bundle.background_cis, bundle.background_trans,
            binsize=fam.bin_bp), equal_nan=True)
    digests = cert.digests(bundle, inp)
    jb32 = bundle_to_jax(bundle)
    assert cert.digests(jb32, inp) == digests
    del bundle
    outputs, seconds = {}, {}
    for dtype in dtypes:
        jb = jzoo.cast_bundle(jb32, dtype)
        seconds[dtype] = 0.0
        with pytest.MonkeyPatch.context() as mp:
            if dtype == "bfloat16":
                mp.setattr(jenc, "_default_block_group",
                           lambda block_bp, rows: min(rows, BF16_ROWS))
            for zoom in fam.zooms():
                out, s = _seconds(lambda: run_jax(fam, jb, inp, zoom))
                outputs[cert.key(fam.name, dtype, zoom)] = out
                seconds[dtype] += s
    names = list(outputs[cert.key(fam.name, dtypes[0], next(iter(
        fam.zooms())))].maps)
    entry = {
        "geometry": fam.describe(), "zooms": fam.zooms(), "levels": names,
        "dtypes": list(dtypes), "digests": digests,
        "seed": cert.SEED, "input_seed": cert.INPUT_SEED,
        "seconds": seconds, "commit": _commit(), "host": host(),
        "versions": {"jax": jax.__version__, "numpy": np.__version__,
                     "torch": torch.__version__},
    }
    if "bfloat16" in dtypes:
        entry["bf16_vs_fp32"] = {
            zoom: {lv: float(np.abs(
                outputs[cert.key(fam.name, "bfloat16", zoom)].maps[lv]
                - outputs[cert.key(fam.name, "float32", zoom)].maps[lv]).max())
                for lv in names}
            for zoom in fam.zooms()}
    return entry, outputs


def write_family(path, family, entry, outputs):
    """Merge `family`'s entry and outputs into the reference at `path`."""
    if path.exists():
        ref = cert.load_reference(path)
        header = {k: v for k, v in ref.header.items()
                  if k not in ("arrays", "starts")}
        kept = {k: v for k, v in ref.outputs.items()
                if not k.startswith(family + ":")}
    else:
        header, kept = {"format": 1, "families": {}}, {}
    header["families"][family] = entry
    cert.save_reference(path, header, {**kept, **outputs})


def not_run_bf16_256m(entry_32m):
    """The 256 Mb bf16 entry's note: the estimate from the 32 Mb bf16
    seconds per Mb of window and zoom."""
    per_mb, est = estimate_256m(entry_32m["seconds"]["bfloat16"],
                                entry_32m["geometry"]["window_bp"],
                                len(entry_32m["zooms"]))
    return {"reason": NOT_RUN_BF16_256M, "seconds_per_Mb": per_mb,
            "estimated_seconds": est}


# the header keys of a family's entry that a regeneration must reproduce
DETERMINISTIC = ("geometry", "zooms", "levels", "dtypes", "digests", "seed",
                 "input_seed")


def assert_same_entry(ref, family, entry, outputs):
    """A regenerated entry equals the reference's: the deterministic header
    keys, the starts, and every array and orca_tpu's own bf16-vs-fp32
    figures bit for bit on the header's host, else within SPREAD."""
    want = ref.header["families"][family]
    for k in DETERMINISTIC:
        assert entry.get(k) == want.get(k), k
    # an --xla_cpu_* flag (--xla_cpu_max_isa, say) can change XLA:CPU's
    # code: with one set, no host is the header's
    same_host = (entry["host"] == want.get("host")
                 and "--xla_cpu_" not in os.environ.get("XLA_FLAGS", ""))
    keys = sorted(k for k in ref.outputs if k.startswith(family + ":"))
    assert keys == sorted(outputs)
    for k in keys:
        assert outputs[k].starts == ref.outputs[k].starts, k
        d = cert.max_abs_diffs(ref.outputs[k], outputs[k])
        spread = 0.0 if same_host else SPREAD[k.split(":")[1]]
        print(f"{k}: max|d| against the file by level {d} (held to "
              f"{spread:.3e})")
        assert all(v <= spread for v in d.values()), (k, d, spread)
    for zoom, figs in want.get("bf16_vs_fp32", {}).items():
        for lv, v in figs.items():
            got = entry["bf16_vs_fp32"][zoom][lv]
            assert got == v if same_host else (
                abs(got - v) <= SPREAD["float32"] + SPREAD["bfloat16"]), (
                zoom, lv, got, v)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["1m", "32m", "256m"])
def test_reference_regenerates(family):
    """orca_tpu regenerates the family's reference on the CPU, bit for bit
    on the header's host (or writes it: see the module's docstring)."""
    ref = cert.load_reference(REFERENCE) if REFERENCE.exists() else None
    write = (ref is None or family not in ref.header["families"]
             or os.environ.get("ORCA_CERTIFY_CARD_WRITE") == "1")
    if write and family == "256m" and (
            ref is None or "32m" not in ref.header["families"]):
        pytest.fail("the 256m entry's bf16 estimate reads the 32m entry's "
                    "bf16 seconds: write the 32m entry first")
    entry, outputs = generate(cert.FULL[family], DTYPES[family])
    if write:
        if family == "256m":
            entry["not_run"] = {"bfloat16": not_run_bf16_256m(
                ref.header["families"]["32m"])}
        REFERENCE.parent.mkdir(exist_ok=True)
        write_family(REFERENCE, family, entry, outputs)
        ref = cert.load_reference(REFERENCE)
    assert_same_entry(ref, family, entry, outputs)
    assert REFERENCE.stat().st_size <= MAX_BYTES


# ---------------------------------------------------------------------------
# the fast gate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    return cert.load_reference(REFERENCE)


@pytest.mark.parametrize("family", ["1m", "32m", "256m"])
def test_port_bundles_hash_to_the_reference(reference, family):
    """The port's seeded random bundles, folded, and the inputs (1m and
    32m; 256m's on the card) hash to the reference's digests: a change to
    the port's init or the inputs' generator would make the reference
    stale."""
    fam = cert.FULL[family]
    bundle = fam.weights()
    want = reference.header["families"][family]["digests"]
    got = cert.digests(bundle, {} if family == "256m"
                       else fam.inputs(bundle))
    assert {k: want[k] for k in got} == got


def test_reference_layout(reference):
    """The file's header and arrays match the families' geometries, levels,
    dtypes and zooms, and it stays within 5 MB."""
    assert REFERENCE.stat().st_size <= MAX_BYTES
    fams = reference.header["families"]
    assert sorted(fams) == ["1m", "256m", "32m"]
    want_levels = {"1m": ["2d", "1d"],
                   "32m": ["32", "16", "8", "4", "2", "1"],
                   "256m": ["256", "128", "64", "32"]}
    keys = set()
    for name, fam in cert.FULL.items():
        e = fams[name]
        assert e["geometry"] == fam.describe()
        assert e["zooms"] == fam.zooms()
        assert e["levels"] == want_levels[name]
        assert tuple(e["dtypes"]) == DTYPES[name]
        assert set(e["digests"]) == {"weights", "backgrounds", "sequence"} | (
            {"normmat"} if name == "256m" else set())
        assert set(e["host"]) == {"cpu", "cpu_flags_sha256", "threads"}
        for dtype in e["dtypes"]:
            for zoom in fam.zooms():
                k = cert.key(name, dtype, zoom)
                keys.add(k)
                out = reference.outputs[k]
                assert list(out.maps) == e["levels"]
                for lv, a in out.maps.items():
                    shape = (250, cert.NUM_1D) if lv == "1d" else (250, 250)
                    assert a.shape == shape and np.isfinite(a).all()
                assert (out.starts is None) == (name == "1m")
                if out.starts is not None:
                    assert len(out.starts) == len(e["levels"])
                if dtype == "bfloat16":
                    assert set(e["bf16_vs_fp32"][zoom]) == set(e["levels"])
                    assert all(v > 0 for v in e["bf16_vs_fp32"][zoom].values())
    assert set(reference.outputs) == keys
    assert set(fams["256m"]["not_run"]) == {"bfloat16"}
    for k, info in reference.header["arrays"].items():
        assert info["packed"] == ("full" if k.endswith(":1d") else "triu"), k


@pytest.mark.parametrize("family", ["1m", "32m", "256m"])
def test_inverse_converter_round_trips(family):
    """port -> orca_tpu (`bundle_to_jax`) -> port (`bundle_from_numpy`) is
    bit-equal, and orca_tpu's class has the port's fields."""
    bundle = SMALL[family].weights()
    jb = bundle_to_jax(bundle)
    assert type(jb).__module__ == "orca_tpu.models.zoo"
    assert ([f.name for f in dataclasses.fields(jb)]
            == [f.name for f in dataclasses.fields(bundle)])
    back = bundle_from_numpy(jb, "cpu")
    assert type(back) is type(bundle)
    a, b = jax.tree.leaves(jb), jax.tree.leaves(bundle_to_jax(back))
    assert len(a) == len(b) and all(
        np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    assert cert.digests(back, {}) == cert.digests(bundle, {})
    for f in dataclasses.fields(bundle):
        v = getattr(bundle, f.name)
        if isinstance(v, (str, int, float, type(None))):
            assert getattr(back, f.name) == v


@pytest.fixture(scope="module")
def small_reference(tmp_path_factory):
    """A float32 reference at the small geometries, written by `generate`
    (256m: both packages' tower replaced by the same seeded encodings)."""
    path = tmp_path_factory.mktemp("certify_card") / "small.npz"
    with pytest.MonkeyPatch.context() as mp:
        _seeded_encodings_256m(mp, SMALL["256m"].geometry)
        for name, fam in SMALL.items():
            entry, outputs = generate(fam, ("float32",))
            write_family(path, name, entry, outputs)
    return path


@pytest.fixture(scope="module")
def port_outputs():
    """The port's outputs at the small geometries by (family, zoom), filled
    once: each test below holds the same outputs to another reference."""
    return {}


def _certify_small(path, family, monkeypatch, port_outputs):
    """`certify_family` at the small geometry against the reference at
    `path`, the port's CPU plain path run once a family and zoom."""
    if family == "256m":
        _seeded_encodings_256m(monkeypatch, SMALL["256m"].geometry)
    fam = SMALL[family]
    run = type(fam).run

    def once(fam, bundle, inp, zoom, device):
        if (fam.name, zoom) not in port_outputs:
            port_outputs[fam.name, zoom] = run(fam, bundle, inp, zoom, device)
        return port_outputs[fam.name, zoom]

    monkeypatch.setattr(type(fam), "run", once)
    return cert.certify_family(cert.load_reference(path), fam, "cpu",
                               log=lambda line: None)


@pytest.mark.parametrize("family", ["1m", "32m", "256m"])
def test_comparison_on_the_cpu_plain_path(small_reference, family,
                                          monkeypatch, port_outputs):
    """The card phase's comparison on the CPU plain path at the small
    geometries: within 2.0e-6 of orca_tpu, starts equal, every level
    passing."""
    report = _certify_small(small_reference, family, monkeypatch,
                            port_outputs)
    zooms = report["float32"]
    assert set(zooms) == set(SMALL[family].zooms())
    for fig in zooms.values():
        assert fig["pass"] and fig["starts_equal"]
        for lv in fig["levels"].values():
            assert lv["max_abs_diff"] <= cert.BAR_FP32 == lv["bar"]


def test_doctored_reference_fails(small_reference, tmp_path, monkeypatch,
                                  port_outputs):
    """One level shifted by 1e-5 reads pass: false (under the 1e-4 limit,
    so the comparison goes on); a changed start raises."""
    ref = cert.load_reference(small_reference)
    k = cert.key("32m", "float32", "mpos_frac_0.13")
    header = {n: v for n, v in ref.header.items()
              if n not in ("arrays", "starts")}
    shifted = dict(ref.outputs)
    shifted[k] = cert.Output(dict(ref.outputs[k].maps), ref.outputs[k].starts)
    shifted[k].maps["4"] = shifted[k].maps["4"] + np.float32(1e-5)
    path = tmp_path / "shifted.npz"
    cert.save_reference(path, header, shifted)
    fig = _certify_small(path, "32m", monkeypatch, port_outputs)["float32"][
        "mpos_frac_0.13"]
    assert not fig["pass"] and not fig["levels"]["4"]["pass"]
    assert fig["levels"]["4"]["max_abs_diff"] > 5e-6
    assert all(f["pass"] for lv, f in fig["levels"].items() if lv != "4")

    moved = dict(ref.outputs)
    moved[k] = cert.Output(ref.outputs[k].maps,
                           [s + 4000 * (i == 2) for i, s in
                            enumerate(ref.outputs[k].starts)])
    cert.save_reference(path, header, moved)
    with pytest.raises(cert.CertifyError, match="starts"):
        _certify_small(path, "32m", monkeypatch, port_outputs)


@pytest.mark.parametrize("shift,same_host,holds", [
    (0.0, True, True), (1e-6, True, False), (1e-6, False, True),
    (3e-6, False, False)])
def test_regeneration_check(small_reference, shift, same_host, holds):
    """The slow case's check: an entry regenerated on the header's host
    must equal the file bit for bit; on another host (another CPU flags
    digest) each array must be within SPREAD."""
    ref = cert.load_reference(small_reference)
    entry = dict(ref.header["families"]["32m"])
    if not same_host:
        entry["host"] = dict(entry["host"], cpu_flags_sha256="0" * 64)
    outputs = {k: cert.Output({lv: a + np.float32(shift)
                               for lv, a in out.maps.items()}, out.starts)
               for k, out in ref.outputs.items() if k.startswith("32m:")}
    if holds:
        assert_same_entry(ref, "32m", entry, outputs)
    else:
        with pytest.raises(AssertionError):
            assert_same_entry(ref, "32m", entry, outputs)


@pytest.mark.parametrize("dtype,times_bar,outcome", [
    ("float32", 0.5, "pass"), ("float32", 3.0, "over the bar"),
    ("float32", 60.0, "raises"), ("float32", float("nan"), "raises"),
    ("bfloat16", 0.5, "pass"), ("bfloat16", 1.5, "over the bar"),
    ("bfloat16", 2.5, "raises")])
def test_compare_limits(dtype, times_bar, outcome):
    """A level within its bar passes; one over it reads pass: false; one
    over the hard limit (float32: LIMIT_REL * max(1, max|ref|), here 50
    bars; bfloat16: LIMIT_BF16 bars) or not finite raises."""
    bar = cert.BAR_FP32 if dtype == "float32" else 0.03
    ref = np.full((3, 3), 0.5, np.float32)
    want = cert.Output({"1": ref, "2": ref}, [0, 0])
    got = cert.Output({"1": ref + np.float32(times_bar * bar), "2": ref},
                      [0, 0])
    bars = {"1": bar, "2": bar}
    if outcome == "raises":
        with pytest.raises(cert.CertifyError, match="limit|non-finite"):
            cert.compare(want, got, bars, dtype)
        return
    fig = cert.compare(want, got, bars, dtype)
    assert fig["levels"]["1"]["pass"] == (outcome == "pass")
    assert fig["levels"]["2"]["pass"] and fig["starts_equal"]
    assert fig["pass"] == (outcome == "pass")
    assert fig["levels"]["1"]["max_abs_diff"] == pytest.approx(
        times_bar * bar, rel=0.05)
