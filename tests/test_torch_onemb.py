"""The port's standalone 1 Mb family (orca_tpu_torch/predict/onemb.py,
`decoders.apply_net`, `zoo.Model1MBundle`) against the JAX package's, at a
40 kb window (10 bins), as tests/test_onemb.py runs it.

One unfolded JAX net is drawn with numpy from the JAX specs (non-trivial
BatchNorm statistics) and carried across with `bundle_from_numpy`; the port
runs it unfolded and folded. fp32: max|d| <= 1e-4 against JAX's output on the
unfolded net; bf16: within twice JAX's own bf16-vs-fp32 difference on the
same bf16-rounded parameters. Each JAX program compiles once, all of them
concurrently, in the module's fixture. The pickle and `load_resources` paths
load JAX-pickled bundles.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.models import zoo as jzoo
from orca_tpu.nn import decoders as jdec
from orca_tpu.nn import encoders as jenc
from orca_tpu.nn.core import fold_params as jfold
from orca_tpu.predict import onemb as jonemb
from orca_tpu.predict import resources as jres
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.predict import onemb as tonemb
from orca_tpu_torch.predict import resources as tres
from test_torch_encoders import numpy_tree, onehot

WINDOW = 40_000
N = 4
ATOL = 1e-4


def jax_net_spec(num_1d):
    spec = {"encoder": jenc.encoder_tower_spec(),
            "decoder": jdec.decoder1m_spec(1)}
    if num_1d:
        spec["final_1d"] = jdec.final1d_spec(num_1d)
    return spec


def jax_1m_bundle(seed, num_1d=32, name="numpy1m"):
    """An unfolded JAX-package Model1MBundle drawn with numpy (host arrays)."""
    net = numpy_tree(jax_net_spec(num_1d), np.random.RandomState(seed))
    d = np.arange(1000, dtype=np.float64)
    normmats, epss = jzoo.normmat_1m_from_expectation(-1.0 * np.log1p(d) - 2.0)
    return jzoo.Model1MBundle(name=name, net=net, num_1d=num_1d,
                              normmats=normmats, epss=epss)


def on_device(host):
    """The JAX bundle with jnp parameters."""
    return jzoo.Model1MBundle(
        name=host.name, net=jax.tree.map(jnp.asarray, host.net),
        num_1d=host.num_1d, normmats=host.normmats, epss=host.epss)


def bf16_rounded(host):
    """The bundle with its float32 parameters rounded once to bf16 (kept in
    float32)."""
    net = jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), host.net)
    return jzoo.Model1MBundle(name=host.name, net=net, num_1d=host.num_1d,
                              normmats=host.normmats, epss=host.epss)


def port(host, folded=False, dtype="float32"):
    bundle = bundle_from_numpy(host, "cpu")
    if folded:
        bundle = tzoo.fold_1m_bundle(bundle)
    return tzoo.cast_bundle(bundle, dtype)


# (id, num_1d, with_1d, rc_average)
CASES = [("tracks_rc", 32, True, True), ("map_only", 32, False, False),
         ("no_head_rc", None, False, True)]


@pytest.fixture(scope="module")
def refs():
    """Hosts, sequences and every JAX output the tests compare with,
    computed with the JAX programs compiled concurrently."""
    hosts = {32: jax_1m_bundle(0, 32), None: jax_1m_bundle(1, None)}
    seq = onehot(2, N, WINDOW)
    screen = onehot(3, 5, WINDOW)
    rounded = bf16_rounded(hosts[32])
    jb16 = jzoo.cast_bundle(on_device(rounded), "bfloat16")
    jobs = {case[0]: (on_device(hosts[case[1]]), case[2], case[3])
            for case in CASES}
    jobs["bf16"] = (jb16, True, True)
    jobs["bf16_ref32"] = (on_device(rounded), True, True)
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(jonemb.predict_1m, b, seq, w1, rc)
                   for k, (b, w1, rc) in jobs.items()}
        out = {k: f.result() for k, f in futures.items()}
    out["screen"] = jonemb.screen_windows(on_device(hosts[32]), screen,
                                          batch_size=4)
    return dict(hosts=hosts, seq=seq, screen_seqs=screen, rounded=rounded,
                out=out)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_predict_1m_fp32_matches_jax(refs, case, folded):
    name, num_1d, with_1d, rc = case
    want = _as_tuple(refs["out"][name])
    got = _as_tuple(tonemb.predict_1m(port(refs["hosts"][num_1d], folded),
                                      refs["seq"], with_1d=with_1d,
                                      rc_average=rc, device="cpu"))
    assert len(got) == len(want) == (2 if with_1d and num_1d else 1)
    assert got[0].shape == (N, 10, 10, 1)
    if len(got) == 2:
        assert got[1].shape == (N, 10, num_1d)
        assert (got[1] >= 0).all() and (got[1] <= 1).all()
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("packed", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_apply_net_matches_jax(refs, folded, packed):
    """`apply_net` itself, on a float or a uint8 quarter-scale input, against
    JAX's `apply_net` (jitted) on the unfolded net."""
    host = refs["hosts"][32]
    x = onehot(4, 2, WINDOW, packed=packed)
    pred, out1d = jax.jit(jdec.apply_net, static_argnames="num_1d")(
        jax.tree.map(jnp.asarray, host.net), jnp.asarray(x), num_1d=32)
    net = port(host, folded).net
    with torch.inference_mode():
        gpred, gout1d = tdec.apply_net(net, torch.from_numpy(x), num_1d=32)
    assert gpred.shape == (2, 10, 10, 1) and gout1d.shape == (2, 10, 32)
    np.testing.assert_allclose(gpred.numpy(), np.asarray(pred), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(gout1d.numpy(), np.asarray(out1d), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_predict_1m_bf16_within_bf16_noise(refs, folded):
    want16 = refs["out"]["bf16"]
    want32 = refs["out"]["bf16_ref32"]
    got = tonemb.predict_1m(port(refs["rounded"], folded, "bfloat16"),
                            refs["seq"], with_1d=True, rc_average=True,
                            device="cpu")
    for g, w16, w32 in zip(got, want16, want32):
        noise = np.abs(np.asarray(w16) - np.asarray(w32)).max()
        d = np.abs(g - np.asarray(w16)).max()
        assert g.dtype == np.float32
        assert noise > 0
        assert d <= 2 * noise, (d, noise)


def test_screen_windows_matches_jax(refs):
    """W=5 windows in chunks of 4: the last chunk is padded with copies of
    its window and cut back."""
    bundle = port(refs["hosts"][32], folded=True)
    got = tonemb.screen_windows(bundle, refs["screen_seqs"], batch_size=4,
                                device="cpu")
    want = refs["out"]["screen"]
    assert got.shape == want.shape == (5, 10, 10, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    single = tonemb.predict_1m(bundle, refs["screen_seqs"][4:5], device="cpu")
    np.testing.assert_allclose(got[4], single[0], rtol=0, atol=1e-6)
    calls = []
    tonemb.screen_windows(bundle, refs["screen_seqs"], batch_size=2,
                          predict_fn=lambda b, s: calls.append(len(s))
                          or np.zeros((len(s), 1)))
    assert calls == [2, 2, 2]


def test_log_fold_map_equal(refs):
    host = refs["hosts"][32]
    pred = np.random.RandomState(12).randn(2, 250, 250, 1).astype(np.float32)
    np.testing.assert_array_equal(
        tonemb.log_fold_map(port(host), pred),
        jonemb.log_fold_map(host, pred))


def test_jax_pickled_1m_bundle_loads(tmp_path):
    """A JAX-package Model1MBundle pickle loads into the port's class with
    every parameter and background equal."""
    host = jax_1m_bundle(5, 32, name="h1esc_1m")
    path = str(tmp_path / "orca_h1esc_1m.bundle")
    jzoo.save_bundle(host, path)
    got = tzoo.load_bundle(path, device="cpu", dtype="float32")
    assert isinstance(got, tzoo.Model1MBundle)
    assert (got.name, got.num_1d) == ("h1esc_1m", 32)
    w, g = jax.tree.leaves(host.net), jax.tree.leaves(got.net)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert got.normmats[1].dtype == np.float64
    np.testing.assert_array_equal(got.normmats[1], host.normmats[1])
    assert got.epss == host.epss
    # and back out through the port's own pickle
    tzoo.save_bundle(got, path)
    again = tzoo.load_bundle(path, device="cpu", dtype="float32")
    for a, b in zip(jax.tree.leaves(again.net), w):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_resources_1m_equal(tmp_path, dtype):
    """Both packages' load_resources(models=['1M']) on JAX pickles: the same
    models and backgrounds (float64, untouched by the cast). The JAX package
    keeps the 1 Mb net unfolded; the port folds it in float32 before the
    cast: its parameters are the port's `fold_1m_bundle` of the float32 load,
    cast to `dtype`, and that fold agrees with the JAX package's
    `fold_params` to float32 rounding."""
    for seed, name in ((6, "h1esc"), (7, "hff")):
        jzoo.save_bundle(jax_1m_bundle(seed, {"h1esc": 32, "hff": 22}[name],
                                       name=f"{name}_1m"),
                         str(tmp_path / f"orca_{name}_1m.bundle"))
    kw = dict(models=["1M"], model_dir=str(tmp_path),
              resource_dir=str(tmp_path))
    want = jres.load_resources(dtype=dtype, **kw)
    want32 = jres.load_resources(dtype="float32", **kw)
    got = tres.load_resources(dtype=dtype, device="cpu", **kw)
    assert list(got.models) == list(want.models) == ["h1esc_1m", "hff_1m"]
    for key, w in want.models.items():
        g = got.models[key]
        assert isinstance(g, tzoo.Model1MBundle)
        assert (g.name, g.num_1d) == (w.name, w.num_1d)
        for ga, wa in ((g.normmats[1], w.normmats[1]), (g.epss[1], w.epss[1])):
            assert np.asarray(ga).dtype == np.asarray(wa).dtype == np.float64
            np.testing.assert_array_equal(ga, wa)
        # JAX's cast reaches the float32 parameters only
        assert all(str(a.dtype) == dtype for a in jax.tree.leaves(w.net))
        assert "bn" not in g.net["encoder"]["lconv"][0][0]
        folded32 = tzoo.fold_1m_bundle(tzoo.load_bundle(
            str(tmp_path / f"orca_{key}.bundle"), device="cpu",
            dtype="float32"))
        jfolded = jax.tree.leaves(jfold(
            jax.tree.map(jnp.asarray, want32.models[key].net),
            jax_net_spec(w.num_1d)))
        leaves = jax.tree.leaves(g.net)
        assert len(leaves) == len(jax.tree.leaves(folded32.net)) == len(
            jfolded) > 0
        for a, b, c in zip(leaves, jax.tree.leaves(folded32.net), jfolded):
            assert a.dtype == getattr(torch, dtype)
            torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0)
            np.testing.assert_allclose(b.numpy(), np.asarray(c), rtol=2e-6,
                                       atol=1e-8)


def test_random_1m_bundle_folds_and_runs():
    """The port's random bundle (the smoke's helper) folds, casts and runs;
    its folded bf16 maps are symmetric and its tracks in [0, 1]."""
    raw = tzoo.random_1m_bundle(0, num_1d=8, device="cpu")
    assert "bn" in raw.net["final_1d"][0]
    folded = tzoo.cast_bundle(tzoo.fold_1m_bundle(raw), "bfloat16")
    assert "bn" not in folded.net["final_1d"][0]
    seq = onehot(8, 2, WINDOW, packed=True)
    pred, tracks = tonemb.predict_1m(folded, seq, with_1d=True,
                                     rc_average=True, device="cpu")
    assert pred.shape == (2, 10, 10, 1) and tracks.shape == (2, 10, 8)
    np.testing.assert_array_equal(pred, pred.transpose(0, 2, 1, 3))
    assert (tracks >= 0).all() and (tracks <= 1).all()
    ref = tonemb.predict_1m(tzoo.fold_1m_bundle(raw), seq, rc_average=True,
                            device="cpu")
    assert np.abs(pred - ref).max() <= 0.05 * np.abs(ref).max()


@pytest.mark.slow
def test_predict_1m_full_window_fp32_matches_jax():
    """One full 1 Mb window (250 bins), fp32, tracks and RC average: the
    port's folded net against JAX's unfolded one."""
    host = jax_1m_bundle(9, 32)
    seq = onehot(10, 1, 1_000_000)
    want = jonemb.predict_1m(on_device(host), seq, True, True)
    got = tonemb.predict_1m(port(host, folded=True), seq, with_1d=True,
                            rc_average=True, device="cpu")
    assert got[0].shape == (1, 250, 250, 1) and got[1].shape == (1, 250, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)

