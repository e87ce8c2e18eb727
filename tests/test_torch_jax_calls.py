"""Calls written for orca_tpu run unchanged against orca_tpu_torch, on the
CPU: the root bench.py's warm-ups (`warmup_cascade_32m(bundle, geom,
n=1)`, :84 and :242, and the float one-hot form of tests/test_warmup.py),
the random bundles with JAX's positional names, the predictions with the
mesh as their last positional argument, and the collectives' JAX keywords.
The port's own `device` is passed by keyword, as its additions are
keyword-only.

A warm-up runs one request on n all-zero windows, 2n rows (forward and
reverse complement), returns its seconds, and leaves the next request's
outputs unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.parallel import mesh as tmesh
from orca_tpu_torch.parallel import multihost
from orca_tpu_torch.predict import multiscale as tms
from orca_tpu_torch.predict.retrieval import assemble_normmat

GEOM = tms.CascadeGeometry(512_000, 4000, 4)
GEOM256 = tms.CascadeGeometry(8_192_000, 32_000, 8)
CPU = torch.device("cpu")


def cpu_mesh(shape):
    return tmesh.make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


@pytest.fixture(scope="module")
def bundle32():
    return tzoo.fold_bundle(tzoo.random_32m_bundle(
        0, nbins=GEOM.bins, crop=GEOM.crop, device="cpu"))


def _request(bundle, seq):
    return tms.genomepredict(seq, "chrS", GEOM.window_bp // 3,
                             GEOM.window_bp // 2, [bundle], geometry=GEOM,
                             device="cpu")


def _assert_same(got, want):
    assert got["start_coords"] == want["start_coords"]
    for g, w in zip(got["predictions"][0], want["predictions"][0]):
        np.testing.assert_array_equal(g, w)


def test_bench_warmup_32m_call_forms(bundle32, monkeypatch):
    """bench.py's `warmup_cascade_32m(bundles[0], GEOM_32M, n=1)`, its
    positional form, and the float one-hot form: seconds back, one request
    on the 2n rows of n windows of `seq_dtype`, the next request unchanged."""
    seq = np.random.RandomState(0).rand(1, GEOM.window_bp, 4).astype(
        np.float32)
    before = _request(bundle32, seq)
    seen = []
    real = tms._encode_32mb

    def spy(bundle, seq2, mesh=None):
        seen.append((tuple(seq2.shape), seq2.dtype, int(seq2.sum())))
        return real(bundle, seq2, mesh)

    monkeypatch.setattr(tms, "_encode_32mb", spy)
    for call in (lambda: tms.warmup_cascade_32m(bundle32, GEOM, 1,
                                                device="cpu"),
                 lambda: tms.warmup_cascade_32m(bundle32, GEOM, n=1,
                                                seq_dtype=np.float32,
                                                device="cpu")):
        secs = call()
        assert isinstance(secs, float) and secs > 0
    rows = (2, GEOM.window_bp, 4)
    assert seen == [(rows, torch.uint8, 0), (rows, torch.float32, 0)]
    monkeypatch.setattr(tms, "_encode_32mb", real)
    _assert_same(_request(bundle32, seq), before)


@pytest.mark.parametrize("seq_dtype,want", [
    (np.uint8, torch.uint8), (jnp.uint8, torch.uint8),
    (np.float32, torch.float32), (jnp.float32, torch.float32),
    ("float32", torch.float32), (torch.bfloat16, torch.bfloat16),
])
def test_warmup_rows_and_dtypes(bundle32, monkeypatch, seq_dtype, want):
    """n windows warm 2n rows; numpy, JAX and torch dtypes are read by name
    (the port never imports jax)."""
    seen = []

    def encode(bundle, seq2, mesh=None):
        seen.append((tuple(seq2.shape), seq2.dtype))
        return {lv: torch.zeros(seq2.shape[0], GEOM.bins // lv, 128)
                for lv in tms.LEVEL_ORDER}

    monkeypatch.setattr(tms, "_encode_32mb", encode)
    assert tms.warmup_cascade_32m(bundle32, GEOM, 2, None, seq_dtype,
                                  device="cpu") > 0
    assert seen == [((4, GEOM.window_bp, 4), want)]


def test_warmup_refuses_an_integer_one_hot(bundle32):
    with pytest.raises(ValueError, match="seq_dtype"):
        tms.warmup_cascade_32m(bundle32, GEOM, 1, seq_dtype=np.int32,
                               device="cpu")


def _seeded_256m_encoder(monkeypatch, seen):
    """The port's 256 Mb encoder step gives seeded encodings for 2n rows
    (the bp tower at 8.192 Mb is too slow for the fast gate)."""
    rng = np.random.RandomState(5)
    encs = {lv: rng.randn(4, GEOM256.window_bp // (4000 * lv), 128)
            .astype(np.float32) for lv in tzoo.LEVELS_256M}

    def encode(bundle, seq, mesh=None):
        seen.append((tuple(seq.shape), seq.dtype, mesh))
        rows = 2 * seq.shape[0]
        return {lv: torch.from_numpy(encs[lv][:rows]) for lv in encs}

    monkeypatch.setattr(tms, "_encode_256mb_fwd_rc", encode)


def test_bench_warmup_256m_call_forms(monkeypatch):
    """bench.py's `warmup_cascade_256m(bundle, GEOM_256M, n=1)` and the
    float one-hot form, then a request equal to the one before."""
    seen = []
    _seeded_256m_encoder(monkeypatch, seen)
    bundle = tzoo.fold_256m_bundle(tzoo.random_256m_bundle(0, device="cpu"))
    chrlen = int(GEOM256.window_bp * 0.75) // GEOM256.bin_bp * GEOM256.bin_bp
    normmat = assemble_normmat(
        [["chrM", 0, chrlen, "+"], ["chrP", 0, GEOM256.window_bp - chrlen,
                                    "+"]],
        bundle.background_cis, bundle.background_trans,
        binsize=GEOM256.bin_bp)
    seq = np.zeros((1, GEOM256.window_bp, 4), np.uint8)

    def request():
        return tms.genomepredict_256mb(
            seq, "chrM", [normmat], chrlen, int(chrlen * 0.9),
            GEOM256.window_bp // 2, [bundle], geometry=GEOM256, device="cpu")

    before = request()
    for kw in ({}, {"seq_dtype": np.float32}):
        secs = tms.warmup_cascade_256m(bundle, GEOM256, n=1, device="cpu",
                                       **kw)
        assert isinstance(secs, float) and secs > 0
    assert tms.warmup_cascade_256m(bundle, GEOM256, 2, device="cpu") > 0
    rows = (1, GEOM256.window_bp, 4)
    assert [s[:2] for s in seen] == [
        (rows, torch.uint8), (rows, torch.uint8), (rows, torch.float32),
        ((2,) + rows[1:], torch.uint8)]
    _assert_same(request(), before)


def test_random_bundles_take_jax_positions():
    """`random_32m_bundle(0, "h1esc")` and its siblings bind JAX's name,
    upsample_mode, up_pass, nbins and crop positionally."""
    assert tzoo.random_32m_bundle(0, "h1esc", device="cpu").name == "h1esc"
    assert tzoo.random_256m_bundle(0, "y", device="cpu").name == "y"
    for got, want in (
        (tzoo.random_32m_bundle(0, "x", "nearest", False, 256, 8,
                                device="cpu"),
         jzoo.random_32m_bundle(0, "x", "nearest", False, 256, 8)),
        (tzoo.random_leukemia_bundle(0, 2, "x", 256, 8, device="cpu"),
         jzoo.random_leukemia_bundle(0, 2, "x", 256, 8)),
    ):
        assert (got.name, got.upsample_mode, got.pyramid_up_pass,
                got.num_2d, got.decoder_1pt is None) == (
            want.name, want.upsample_mode, want.pyramid_up_pass,
            want.num_2d, want.decoder_1pt is None)
        assert sorted(got.normmats) == sorted(want.normmats)
        for lv in want.normmats:
            np.testing.assert_allclose(got.normmats[lv], want.normmats[lv],
                                       rtol=1e-12)
        assert got.epss == pytest.approx(want.epss, rel=1e-12)


def test_jax_call_forms_need_cuda_without_device(bundle32):
    """Without `device` the JAX call forms mean CUDA: a name or a window
    count never lands in the device's place."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for call in (lambda: tzoo.random_32m_bundle(0, "h1esc"),
                 lambda: tzoo.random_256m_bundle(0, "y"),
                 lambda: tzoo.random_leukemia_bundle(0, 2, "x"),
                 lambda: tms.warmup_cascade_32m(bundle32, GEOM, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_predictions_take_the_mesh_positionally(bundle32, monkeypatch):
    """`genomepredict(..., geometry, mesh)` and `genomepredict_256mb(...,
    geometry, mesh)` positionally, as the JAX package orders them."""
    seen = []

    def tower(params, seq, mesh, **kw):
        seen.append(mesh)
        return torch.zeros(seq.shape[0], seq.shape[1] // 4000, 128)

    monkeypatch.setattr(tms, "sharded_encoder_tower", tower)
    mesh = cpu_mesh((1, 2))
    seq = np.zeros((1, GEOM.window_bp, 4), np.float32)
    out = tms.genomepredict(seq, "c", GEOM.window_bp // 2, GEOM.window_bp // 2,
                            [bundle32], None, None, 1.0, GEOM, mesh,
                            device="cpu")
    assert seen == [mesh] and len(out["predictions"][0]) == 6

    seen256 = []
    _seeded_256m_encoder(monkeypatch, seen256)
    b256 = tzoo.fold_256m_bundle(tzoo.random_256m_bundle(0, device="cpu"))
    normmat = np.ones((GEOM256.bins, GEOM256.bins), np.float32)
    seq = np.zeros((1, GEOM256.window_bp, 4), np.uint8)
    out = tms.genomepredict_256mb(
        seq, "chrM", [normmat], GEOM256.window_bp, GEOM256.window_bp // 2,
        GEOM256.window_bp // 2, [b256], None, None, "chrP", 1.0, GEOM256,
        mesh, device="cpu")
    assert [s[2] for s in seen256] == [mesh]
    assert out["padding_chr"] == "chrP"


def test_collectives_take_jax_keywords():
    """`shard_batch(mesh, *arrays, batch_axis="data")` and
    `fetch_global(array)`, one process."""
    mesh = cpu_mesh((1, 1))
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(
        multihost.shard_batch(mesh, x, batch_axis="data").numpy(), x)
    with pytest.raises(ValueError, match="batch_axis"):
        multihost.shard_batch(mesh, x, batch_axis="seq")
    np.testing.assert_array_equal(
        multihost.fetch_global(array=torch.from_numpy(x)), x)
    np.testing.assert_array_equal(
        multihost.fetch_global(torch.from_numpy(x), mesh=mesh), x)
