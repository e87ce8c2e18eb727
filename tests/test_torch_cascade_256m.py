"""The port's 256 Mb cascade (orca_tpu_torch/predict/multiscale.py,
`genomepredict_256mb`) against the JAX package's at the scaled test geometry
CascadeGeometry(8_192_000, 32_000, 8): 256 bins of 32 kb, crop 8, levels
256/128/64/32 at block factors 32/16/8/4.

One folded JAX Model256MBundle is built with numpy from the JAX specs and
carried across with `bundle_from_numpy`. The first chromosome covers 0.75 of
the window, so zoom proposals near its end are clamped; its background comes
from the JAX package's `assemble_normmat` over two regions, with NaNs past
bin 150 of the cis expectation, so the NaN fill runs. The bp-resolution tower
is replaced in both packages by the same seeded encodings (the CPU tower at
this window is too slow for the fast gate; the `slow` test runs it).

Zoom starts, end coordinates, annotations and names must be equal; fp32 maps
agree to max|d| <= 1e-4, backgrounds and experiments to rtol 1e-6 (NaNs
equal); bf16 maps within twice the JAX cascade's own bf16-vs-fp32 difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import decoders as jdec
from orca_tpu.nn import encoders as jenc
from orca_tpu.predict import multiscale as jms
from orca_tpu.predict.retrieval import assemble_normmat
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.predict import multiscale as tms
from test_torch_encoders import numpy_tree

GEOM_J = jms.CascadeGeometry(8_192_000, 32_000, 8)
GEOM_T = tms.CascadeGeometry(8_192_000, 32_000, 8)
WPOS = GEOM_J.window_bp // 2
CHRLEN = int(GEOM_J.window_bp * 0.75) // GEOM_J.bin_bp * GEOM_J.bin_bp
LEVELS = jzoo.LEVELS_256M
ANNOTATION = [(0.1, 0.3, "a"), (0.45, 0.52, "b"), (0.5, "p"), (0.9, "q")]


def jax_256m_bundle(seed=0):
    """A folded JAX-package Model256MBundle with numpy-drawn parameters and
    a cis expectation that is NaN past bin 150."""
    rng = np.random.RandomState(seed)

    def tree(spec):
        return jax.tree.map(jnp.asarray, numpy_tree(spec, rng))

    d = np.arange(150, dtype=np.float64)
    bundle = jzoo.Model256MBundle(
        name="numpy256",
        encoder=tree(jenc.encoder_tower_spec()),
        pyramid1=tree(jenc.pyramid_spec(5, True)),
        pyramid=tree(jenc.pyramid_spec(3, True)),
        decoders={lv: tree(jdec.decoder_spec(1)) for lv in LEVELS},
        background_cis=np.hstack(
            [np.exp(-1.2 * np.log1p(d) - 3.0), np.repeat(np.nan, 2000)]
        ),
        background_trans=float(np.exp(-9.0)),
    )
    return jzoo.fold_256m_bundle(bundle)


@pytest.fixture(scope="module")
def bundles():
    jb = jax_256m_bundle()
    return jb, bundle_from_numpy(jax.tree.map(np.asarray, jb), "cpu")


def background(jb):
    return assemble_normmat(
        [["chrM", 0, CHRLEN, "+"], ["chrP", 0, GEOM_J.window_bp - CHRLEN, "+"]],
        jb.background_cis, jb.background_trans, binsize=GEOM_J.bin_bp,
    )


def encodings(seed=5):
    """Seeded fwd+RC encodings at levels 32..256: (2, 64/32/16/8, 128)."""
    rng = np.random.RandomState(seed)
    return {lv: rng.randn(2, GEOM_J.window_bp // (4000 * lv), 128)
            .astype(np.float32) for lv in LEVELS}


def replace_encoders(monkeypatch, encs, jdtype=jnp.float32,
                     tdtype=torch.float32):
    """Both packages' encoder step returns `encs` in the given dtypes."""
    monkeypatch.setattr(
        jms, "_encode_256mb_jit",
        lambda bundle, geom, seq, mesh=None: tuple(
            jnp.asarray(encs[lv], jdtype) for lv in LEVELS),
    )
    monkeypatch.setattr(
        tms, "_encode_256mb_fwd_rc",
        lambda bundle, seq, mesh=None: {
            lv: torch.from_numpy(encs[lv]).to(tdtype) for lv in LEVELS},
    )


def target():
    """An observed map over the window with NaN bins, (1, bins, bins)."""
    rng = np.random.RandomState(3)
    t = rng.rand(GEOM_J.bins, GEOM_J.bins)
    t[rng.rand(*t.shape) < 0.2] = np.nan
    return t[None]


def sequence(seed=42):
    rng = np.random.RandomState(seed)
    return np.eye(4, dtype=np.float32)[rng.randint(0, 4, (1, GEOM_J.window_bp))]


def assert_same_coords(got, want):
    for key in ("start_coords", "end_coords", "annos", "chr", "padding_chr"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mpos_frac", [0.3, 0.62, 0.74])
def test_genomepredict_256mb_matches_jax(bundles, monkeypatch, mpos_frac):
    jb, tb = bundles
    replace_encoders(monkeypatch, encodings())
    mpos = int(GEOM_J.window_bp * mpos_frac)
    nm = background(jb)
    assert np.isnan(nm).any()
    kw = dict(targets=[target()], annotation=ANNOTATION, padding_chr="chrP",
              nan_thresh=0.5)
    seq = np.zeros((1, GEOM_J.window_bp, 4), np.float32)
    want = jms.genomepredict_256mb(seq, "chrM", [nm], CHRLEN, mpos, WPOS,
                                   [jb], geometry=GEOM_J, **kw)
    got = tms.genomepredict_256mb(seq, "chrM", [nm], CHRLEN, mpos, WPOS,
                                  [tb], geometry=GEOM_T, device="cpu", **kw)
    assert_same_coords(got, want)
    if mpos_frac == 0.74:  # at the chromosome's end: every level clamped
        assert want["end_coords"] == [CHRLEN] * len(LEVELS)
    filled = nm.astype(np.float32)
    filled[np.isnan(filled)] = np.nanmin(filled)
    for j, lv in enumerate(sorted(LEVELS, reverse=True)):
        factor = GEOM_J.bins // (GEOM_J.crop * 2**j)
        s = (want["start_coords"][j] - (WPOS - GEOM_J.window_bp // 2)) // GEOM_J.bin_bp
        n = GEOM_J.crop * factor
        exact = (filled[s : s + n, s : s + n].astype(np.float64)
                 .reshape(GEOM_J.crop, factor, GEOM_J.crop, factor)
                 .mean(axis=(1, 3)))
        bg = got["normmats"][0][lv]
        np.testing.assert_allclose(bg, exact, rtol=1e-6,
                                   err_msg=f"background, level {lv}")
        # XLA:CPU sums a block in float32 one term after another: its mean
        # is within (terms - 1) float32 ulps of the exact one
        bound = factor**2 * 2.0**-24
        np.testing.assert_allclose(bg, want["normmats"][0][lv], rtol=bound,
                                   err_msg=f"background vs JAX, level {lv}")
        np.testing.assert_allclose(got["experiments"][0][j],
                                   want["experiments"][0][j], rtol=0,
                                   atol=2 * bound,
                                   err_msg=f"experiment, level {lv}")
        g, w = got["predictions"][0][j], want["predictions"][0][j]
        assert g.shape == (GEOM_J.crop, GEOM_J.crop)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=f"map, level {lv}")


def test_genomepredict_256mb_bf16_within_bf16_noise(bundles, monkeypatch):
    jb, _ = bundles
    jb16 = jzoo.cast_bundle(jb, "bfloat16")
    # fp32 on the bf16-rounded parameters: the cascade's own rounding noise
    jb32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if getattr(a, "dtype", None) == jnp.bfloat16 else a, jb16)
    tb16 = bundle_from_numpy(jax.tree.map(np.asarray, jb32), "cpu",
                             torch.bfloat16)
    encs = {lv: np.array(jnp.asarray(e, jnp.bfloat16).astype(jnp.float32))
            for lv, e in encodings(6).items()}
    nm = background(jb)
    mpos = int(GEOM_J.window_bp * 0.62)
    seq = np.zeros((1, GEOM_J.window_bp, 4), np.float32)
    args = ("chrM", [nm], CHRLEN, mpos, WPOS)
    replace_encoders(monkeypatch, encs, jnp.float32, torch.bfloat16)
    want32 = jms.genomepredict_256mb(seq, *args, [jb32], geometry=GEOM_J)
    replace_encoders(monkeypatch, encs, jnp.bfloat16, torch.bfloat16)
    # XLA:CPU compiles bf16 decoders slowly: compile both programs at once
    jms.warmup_cascade_256m(jb16, GEOM_J)
    want16 = jms.genomepredict_256mb(seq, *args, [jb16], geometry=GEOM_J)
    got = tms.genomepredict_256mb(seq, *args, [tb16], geometry=GEOM_T,
                                  device="cpu")
    assert got["start_coords"] == want16["start_coords"]
    noise = max(np.abs(a - b).max() for a, b in zip(want16["predictions"][0],
                                                     want32["predictions"][0]))
    d = max(np.abs(a - b).max() for a, b in zip(got["predictions"][0],
                                                 want16["predictions"][0]))
    assert noise > 0
    assert d <= 2 * noise, (d, noise)


def test_encode_256mb_matches_jax(bundles, monkeypatch):
    """The 32 Mb pyramid's last output into the 3-level pyramid, at all four
    levels, on the same tower features in both packages."""
    jb, tb = bundles
    feats = np.random.RandomState(9).randn(2, 256, 128).astype(np.float32)
    monkeypatch.setattr(jenc, "apply_encoder_tower",
                        lambda params, seq, **kw: jnp.asarray(feats))
    monkeypatch.setattr(tenc, "apply_encoder_tower",
                        lambda params, seq, **kw: torch.from_numpy(feats))
    want = jms._encode_256mb(jb, jnp.zeros((2, 8, 4)))
    got = tms._encode_256mb(tb, torch.zeros(2, 8, 4))
    assert sorted(got) == sorted(want) == list(LEVELS)
    for lv in LEVELS:
        assert got[lv].shape == (2, 256 // lv, 128)
        np.testing.assert_allclose(got[lv].numpy(), np.asarray(want[lv]),
                                   rtol=0, atol=1e-4, err_msg=f"level {lv}")


@pytest.mark.slow
def test_genomepredict_256mb_real_tower_matches_jax(bundles):
    """The whole 256 Mb path with the bp-resolution tower in both packages
    (the port's plain versions of the kernels on the CPU)."""
    jb, tb = bundles
    nm = background(jb)
    mpos = int(GEOM_J.window_bp * 0.62)
    seq = sequence()
    want = jms.genomepredict_256mb(seq, "chrM", [nm], CHRLEN, mpos, WPOS,
                                   [jb], geometry=GEOM_J)
    got = tms.genomepredict_256mb(seq, "chrM", [nm], CHRLEN, mpos, WPOS,
                                  [tb], geometry=GEOM_T, device="cpu")
    assert got["start_coords"] == want["start_coords"]
    for g, w in zip(got["predictions"][0], want["predictions"][0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
