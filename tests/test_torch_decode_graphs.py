"""The decoder levels' CUDA graphs (orca_tpu_torch/predict/multiscale.py,
`_LevelGraphs`).

On the CPU: the cascades, and a training step, never take the graph path
(the counters `decode_graph_captures` and `decode_graph_replays` stay 0);
the graph key tells apart what a captured graph is fixed to; the level
functions keep their signatures.

On a CUDA card (`gpu`; run with `python -m pytest --noconftest -m gpu
tests/test_torch_decode_graphs.py`): at production geometry, in bf16 and
fp32, a replayed level is bit-equal to the eager level (32 Mb top, inner and
level 1 with Decoder_1m, a 256 Mb level), a second replay on other inputs
gives their eager result, a changed background is copied in, a second
bundle captures its own graphs, threads on streams of their own share the
graphs safely; whole `genomepredict` and
`genomepredict_256mb` requests equal the eager path's, and a warm two-model
32 Mb request replays 12 graphs and captures none.
"""

import dataclasses
import inspect
import sys
import threading
import types

import numpy as np
import pytest
import torch

from orca_tpu_torch.models import zoo
from orca_tpu_torch.nn import encoders
from orca_tpu_torch.predict import multiscale as ms
from orca_tpu_torch.training import stages
from orca_tpu_torch.utils import profiling
from orca_tpu_torch.utils import rng as rng_lib

COUNTERS = ("decode_graph_captures", "decode_graph_replays")
GEOM_32 = ms.CascadeGeometry(512_000, 4000, 4)
GEOM_256 = ms.CascadeGeometry(4_096_000, 32000, 4)


class counted:
    """The graph counters of the block: `with counted() as c: ...`, then
    `c.captures`, `c.replays`."""

    def __enter__(self):
        self.previous = profiling.enable(True)
        profiling.take()
        return self

    def __exit__(self, *exc):
        counters = profiling.take()["counters"]
        profiling.enable(self.previous)
        self.captures, self.replays = (counters.get(k, 0) for k in COUNTERS)
        return False


def stand_in_tower(params, seq, halo_bp=None):
    """(N, L, 4) -> (N, L / 4000, 128) through a fixed map: the CPU runs the
    real tower in seconds, and these tests are about the levels."""
    x = seq.float() * 0.25 if seq.dtype == torch.uint8 else seq.float()
    n, length, _ = x.shape
    means = x.reshape(n, length // 4000, 4000, 4).mean(dim=2)
    return means @ torch.linspace(-1.0, 1.0, 512).reshape(4, 128)


def one_hot(geom, seed):
    rng = np.random.default_rng(seed)
    return np.eye(4, dtype=np.uint8)[
        rng.integers(0, 4, (1, geom.window_bp))] * 4


def mosaic(bins):
    d = np.abs(np.subtract.outer(np.arange(bins), np.arange(bins)))
    return np.exp(-d / 10.0).astype(np.float32)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["32m", "256m"])
def test_cpu_cascades_never_take_the_graph_path(family, monkeypatch):
    monkeypatch.setattr(encoders, "apply_encoder_tower", stand_in_tower)
    with counted() as c:
        if family == "32m":
            bundle = zoo.fold_bundle(zoo.random_32m_bundle(
                nbins=GEOM_32.bins, crop=GEOM_32.crop, device="cpu"))
            out = ms.genomepredict(one_hot(GEOM_32, 1), "c", 300_000,
                                   GEOM_32.window_bp // 2, [bundle] * 2,
                                   geometry=GEOM_32, device="cpu")
        else:
            bundle = zoo.fold_256m_bundle(zoo.random_256m_bundle(
                device="cpu"))
            out = ms.genomepredict_256mb(
                one_hot(GEOM_256, 2), "c", [mosaic(GEOM_256.bins)] * 2,
                3_008_000, 1_500_000, GEOM_256.window_bp // 2, [bundle] * 2,
                geometry=GEOM_256, device="cpu")
    assert len(out["predictions"]) == 2
    assert (c.captures, c.replays) == (0, 0)


def test_training_step_never_takes_the_graph_path():
    """A stage-b step (train=True, autograd) on the CPU at a small geometry:
    its decoders run eager."""
    geom = ms.CascadeGeometry(1_024_000, 4000, 8)
    gen = torch.Generator().manual_seed(3)
    from orca_tpu_torch.nn import decoders

    levels = (32, 1)
    trainable = {"pyramid": encoders.init_pyramid(gen, 5, True),
                 "decoders": {lv: decoders.init_decoder(gen)
                              for lv in levels}}
    feats = torch.randn(2, geom.bins, 128, generator=gen)
    nms, epss = zoo._random_normmats(levels=levels, nbins=geom.bins,
                                     crop=geom.crop)
    cfg = stages.StageBConfig(geometry=geom, encoder_block_bp=None,
                              levels=levels, use_1pt=False, remat=False)
    opt, step = stages.make_stage_b_step(
        cfg, encoder_fn=lambda p, s: feats[: s.shape[0]], device="cpu")
    with counted() as c:
        _, _, metrics = step(
            trainable, {"encoder": {}}, opt.init(trainable),
            torch.zeros(2, 8, 4), torch.rand(2, geom.bins, geom.bins,
                                             generator=gen),
            rng_lib.key(1), 0.002,
            torch.tensor(np.stack([nms[lv] for lv in levels])),
            torch.tensor([epss[lv] for lv in levels]))
    assert np.isfinite(float(metrics["loss"]))
    assert (c.captures, c.replays) == (0, 0)


def test_graph_path_is_off_the_card():
    x = torch.zeros(2, 4, 128)
    with torch.inference_mode():
        assert not ms._graph_path(x, np.zeros((4, 4)), None)
    with torch.no_grad():
        assert not ms._graph_path(x, None)
    assert not ms._graph_path(x)


def _key_inputs(rows=2, dtype=torch.bfloat16, device="cpu", coarse=True,
                nm_dtype=np.float32):
    enc = torch.empty(rows, 250, 128, dtype=dtype, device=device)
    nm = np.zeros((250, 250), nm_dtype)
    co = (torch.empty(rows, 125, 125, 1, dtype=dtype, device=device)
          if coarse else None)
    return enc, nm, co


BUNDLE_A, BUNDLE_B = types.SimpleNamespace(), types.SimpleNamespace()


@pytest.mark.parametrize("change", [
    "rows", "dtype", "device", "bundle", "coarse", "level", "background"])
def test_graph_key_separates(change):
    """Each thing a graph is captured for gives another key; a new request
    of the same kind (new tensors, new background values) gives the same."""
    base = ms._graph_key(BUNDLE_A, 4, *_key_inputs())
    again = ms._graph_key(BUNDLE_A, 4, *_key_inputs())
    assert base == again
    other = {
        "rows": lambda: ms._graph_key(BUNDLE_A, 4, *_key_inputs(rows=4)),
        "dtype": lambda: ms._graph_key(
            BUNDLE_A, 4, *_key_inputs(dtype=torch.float32)),
        "device": lambda: ms._graph_key(
            BUNDLE_A, 4, *_key_inputs(device="meta")),
        "bundle": lambda: ms._graph_key(BUNDLE_B, 4, *_key_inputs()),
        "coarse": lambda: ms._graph_key(
            BUNDLE_A, 4, *_key_inputs(coarse=False)),
        "level": lambda: ms._graph_key(BUNDLE_A, 8, *_key_inputs()),
        "background": lambda: ms._graph_key(
            BUNDLE_A, 4, *_key_inputs(nm_dtype=np.float64)),
    }[change]()
    assert other != base


def test_dropped_bundle_forgets_only_its_graphs():
    graphs = ms._LevelGraphs()
    graphs._graphs.update({(1, 32): "a", (1, 16): "b", (2, 32): "c"})
    graphs._drop(1)
    assert graphs._graphs == {(2, 32): "c"}


@pytest.mark.parametrize("fn,params", [
    ("_decode_level", ["bundle", "geom", "level", "enc_crop", "log_nm",
                       "start_bins", "mpos", "wpos", "coarse"]),
    ("_decode_level_256", ["bundle", "geom", "level", "factor", "enc_crop",
                           "normmat_r", "start_bins", "mpos", "wpos",
                           "chrlen", "coarse"]),
])
def test_level_functions_keep_their_signatures(fn, params):
    """The benchmark's `decode_ms` and the smoke time these by name."""
    sig = inspect.signature(getattr(ms, fn))
    assert list(sig.parameters) == params
    assert all(p.kind is p.POSITIONAL_OR_KEYWORD
               and p.default is p.empty for p in sig.parameters.values())


# --------------------------------------------------------------------------
# CUDA card
# --------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


_bundles = {}


def bundle_32(dtype, seed=0):
    key = ("32m", dtype, seed)
    if key not in _bundles:
        _bundles[key] = zoo.cast_bundle(zoo.fold_bundle(
            zoo.random_32m_bundle(seed, device="cuda")), dtype)
    return _bundles[key]


def bundle_256(dtype, seed=0):
    key = ("256m", dtype, seed)
    if key not in _bundles:
        _bundles[key] = zoo.cast_bundle(zoo.fold_256m_bundle(
            zoo.random_256m_bundle(seed, device="cuda")), dtype)
    return _bundles[key]


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))


def _inputs_32(dtype, j, seed):
    geom = ms.GEOM_32M
    gen = torch.Generator(device="cuda").manual_seed(seed)
    enc = _randn(gen, (2, geom.crop, 128), dtype)
    coarse = (None if j == 0
              else _randn(gen, (2, geom.half, geom.half, 1), dtype))
    start_bins = torch.tensor([1000 + 10 * seed, 3000], dtype=torch.int32,
                              device="cuda")
    pos = torch.tensor(16e6 + 1e5 * seed, device="cuda")
    return enc, start_bins, pos, torch.tensor(16e6, device="cuda"), coarse


def _level_32(bundle, j, inputs, log_nm=None):
    level = sorted(bundle.decoders, reverse=True)[j]
    enc, start_bins, mpos, wpos, coarse = inputs
    log_nm = bundle.log_normmats()[j] if log_nm is None else log_nm
    return ms._decode_level(bundle, ms.GEOM_32M, level, enc, log_nm,
                            start_bins, mpos, wpos, coarse)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where,j", [("top", 0), ("inner", 2),
                                     ("level1_with_1m", 5)])
def test_32m_level_replay_is_eager(dtype, where, j):
    """First call captures, the second replays on other inputs; each is
    bit-equal to the eager level on the same inputs."""
    _card()
    bundle = dataclasses.replace(bundle_32(dtype))  # its own graphs
    assert bundle.decoder_1pt is not None
    assert (sorted(bundle.decoders, reverse=True)[j] == 1) == (j == 5)
    outs = []
    for seed, captures in ((1, 1), (2, 0)):
        inputs = _inputs_32(dtype, j, seed)
        with counted() as c, torch.inference_mode():
            assert ms._graph_path(inputs[0], inputs[4])
            got = _level_32(bundle, j, inputs)
        assert (c.captures, c.replays) == (captures, 1)
        with counted() as c, torch.no_grad():
            assert not ms._graph_path(inputs[0])
            want = _level_32(bundle, j, inputs)
        assert (c.captures, c.replays) == (0, 0)
        _assert_equal(got, want)
        outs.append(got[0])
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_changed_background_is_copied_in(dtype):
    _card()
    bundle = dataclasses.replace(bundle_32(dtype))
    inputs = _inputs_32(dtype, 1, 3)
    log_nm = bundle.log_normmats()[1]
    with torch.inference_mode():
        _level_32(bundle, 1, inputs)
        with counted() as c:
            got = _level_32(bundle, 1, inputs, log_nm * 0.5)
    assert (c.captures, c.replays) == (0, 1)
    with torch.no_grad():
        want = _level_32(bundle, 1, inputs, log_nm * 0.5)
    _assert_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_256m_level_replay_is_eager(dtype):
    _card()
    bundle = dataclasses.replace(bundle_256(dtype))
    geom = ms.GEOM_256M
    j = 1
    level = sorted(bundle.decoders, reverse=True)[j]
    factor = geom.bins // (geom.crop * 2**j)
    outs = []
    for seed, captures in ((1, 1), (2, 0)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        enc = _randn(gen, (2, geom.crop, 128), dtype)
        coarse = _randn(gen, (2, geom.half, geom.half, 1), dtype)
        normmat_r = torch.rand((2, geom.crop, geom.crop), generator=gen,
                               device="cuda") + 0.01
        start_bins = torch.tensor([500, 1500], dtype=torch.int32,
                                  device="cuda")
        mpos, wpos, chrlen = (torch.tensor(v, device="cuda")
                              for v in (100e6 + 1e6 * seed, 128e6, 200e6))
        args = (bundle, geom, level, factor, enc, normmat_r, start_bins,
                mpos, wpos, chrlen, coarse)
        with counted() as c, torch.inference_mode():
            got = ms._decode_level_256(*args)
        assert (c.captures, c.replays) == (captures, 1)
        with torch.no_grad():
            want = ms._decode_level_256(*args)
        _assert_equal(got, want)
        outs.append(got[0])
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_second_bundle_captures_its_own_graphs():
    _card()
    bundles = [dataclasses.replace(bundle_32("bfloat16", seed))
               for seed in (0, 1)]
    inputs = _inputs_32("bfloat16", 3, 4)
    got = []
    for bundle in bundles:
        with counted() as c, torch.inference_mode():
            got.append(_level_32(bundle, 3, inputs))
        assert (c.captures, c.replays) == (1, 1)
    for bundle, g in zip(bundles, got):
        with torch.no_grad():
            _assert_equal(g, _level_32(bundle, 3, inputs))
    assert not torch.equal(got[0][0], got[1][0])


@pytest.mark.gpu
def test_threads_on_their_own_streams_share_the_graphs():
    """Four threads, each on a stream of its own, replay one level's graph
    on their own inputs at once, with a short switch interval; every result
    is its inputs' eager result (the static buffers are never shared by two
    replays in flight)."""
    _card()
    bundle = dataclasses.replace(bundle_32("bfloat16"))
    inputs = [_inputs_32("bfloat16", 2, 10 + i) for i in range(4)]
    with torch.inference_mode():
        _level_32(bundle, 2, inputs[0])
    torch.cuda.synchronize()
    results, errors = {}, []

    def work(i):
        try:
            with torch.inference_mode(), torch.cuda.stream(
                    torch.cuda.Stream()):
                outs = [_level_32(bundle, 2, inputs[i]) for _ in range(3)]
                torch.cuda.current_stream().synchronize()
            results[i] = outs
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(previous)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    assert sorted(results) == [0, 1, 2, 3]
    for i, outs in results.items():
        with torch.no_grad():
            want = _level_32(bundle, 2, inputs[i])
        for got in outs:
            _assert_equal(got, want)


def _assert_same_request(got, want):
    for a, b in zip(got["predictions"], want["predictions"]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert got["start_coords"] == want["start_coords"]
    assert got["end_coords"] == want["end_coords"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_genomepredict_graphed_is_eager(dtype, monkeypatch):
    """Two models at production geometry: the first request captures each
    level, a warm one replays 12 graphs and captures none, and both equal
    the eager path's request."""
    _card()
    bundles = [dataclasses.replace(bundle_32(dtype, seed))
               for seed in (0, 1)]
    seq = one_hot(ms.GEOM_32M, 5)
    wpos = ms.GEOM_32M.window_bp // 2

    def request():
        return ms.genomepredict(seq, "c", wpos + 3_217_000, wpos, bundles)

    with counted() as first:
        cold = request()
    with counted() as warm:
        got = request()
    assert (first.captures, first.replays) == (12, 12)
    assert (warm.captures, warm.replays) == (0, 12)
    monkeypatch.setattr(ms, "_graph_path", lambda *inputs: False)
    with counted() as c:
        want = request()
    assert (c.captures, c.replays) == (0, 0)
    _assert_same_request(cold, want)
    _assert_same_request(got, want)


@pytest.mark.gpu
def test_genomepredict_256mb_graphed_is_eager(monkeypatch):
    """One bf16 256 Mb model at production geometry, a whole-chromosome
    request padded to 256 Mb."""
    _card()
    bundle = dataclasses.replace(bundle_256("bfloat16"))
    geom = ms.GEOM_256M
    seq = one_hot(geom, 6)
    d = np.abs(np.subtract.outer(np.arange(geom.bins, dtype=np.float32),
                                 np.arange(geom.bins, dtype=np.float32)))
    normmat = np.exp(-d / 400.0) + np.float32(1e-4)
    chrlen = 150_000_000
    wpos = geom.window_bp // 2

    def request():
        return ms.genomepredict_256mb(seq, "c", [normmat], chrlen,
                                      60_000_000, wpos, [bundle])

    with counted() as first:
        graphed = request()
    assert (first.captures, first.replays) == (4, 4)
    monkeypatch.setattr(ms, "_graph_path", lambda *inputs: False)
    want = request()
    _assert_same_request(graphed, want)
    for a, b in zip(graphed["normmats"], want["normmats"]):
        for lv in a:
            assert np.array_equal(a[lv], b[lv])
