"""Training in the port (orca_tpu_torch/training, the train mode of nn.core,
nn.encoders and nn.decoders) against orca_tpu.training.

Parity runs both packages in float64 from the same parameter trees (drawn
with numpy from the specs) and the same pinned draws: the JAX package's
`jax.random.bernoulli`/`randint` and `nn_ops.dropout` are replaced, for the
time of its tracing, by functions of the mask's shape and of the call order,
and the port's `utils.rng` by the same functions. Float64, because the
stage steps' gradients are ill-conditioned at these small geometries: the
JAX package's own float32 gradients differ from its float64 ones by ~1e-2 of
max(1, max|g|) (stage a, seq_len 40 kb, measured), so only float64 can hold
the port to the JAX package at 1e-4. Bars: losses and metrics rtol 1e-5;
every leaf of the updated params (BatchNorm running statistics included) and
of the momentum tree within 1e-4 * max(1, max|ref|), over two steps.

Stage a here (single head with 1D tracks, two heads without); stages b and c
are in test_torch_stages.py. Also: losses, the optimizer, the plateau
scheduler, SWA, BatchNorm and dropout in train mode, the port's own draws,
and remat equal to no remat.
"""

import contextlib
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orca_tpu.ops.nn_ops as jops
from orca_tpu.training import losses as jlosses
from orca_tpu.training import optim as joptim
from orca_tpu.training import stages as jst
from orca_tpu.training import swa as jswa
from orca_tpu_torch.models.from_jax import (
    opt_state_from_numpy,
    swa_state_from_numpy,
)
from orca_tpu_torch.nn import core as tcore
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.ops import nn_ops as tops
from orca_tpu_torch.training import losses as tlosses
from orca_tpu_torch.training import optim as toptim
from orca_tpu_torch.training import stages as tst
from orca_tpu_torch.training import swa as tswa
from orca_tpu_torch.utils import rng as trng
from orca_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_encoders import numpy_tree, share_cpu_with_other_workers

share_cpu_with_other_workers()

OFFSETS = (3, 1, 2, 0)  # pinned zoom offsets, taken modulo `half`
LEAF_TOL = 1e-4
LOSS_RTOL = 1e-5


# --------------------------------------------------------------------------
# pinned draws and comparisons, shared with the other training test files
# --------------------------------------------------------------------------


def pinned_mask(shape, keep):
    """A keep-mask that depends on the mask's shape alone."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).rand(*shape) < keep


_trace = threading.local()


def jax_trace(fn, *args):
    """fn(*args) with the pinned randint's call counter at 0 (each JAX
    program is traced in the thread that calls it)."""
    _trace.calls = 0
    return fn(*args)


@contextlib.contextmanager
def jax_pinned(flip=True):
    """Float64 and pinned draws for the JAX package, restored after."""
    mp = pytest.MonkeyPatch()
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    dynamic_slice = jax.lax.dynamic_slice

    def randint(key, shape, minval, maxval, *a, **k):
        i = getattr(_trace, "calls", 0)
        _trace.calls = i + 1
        return jnp.asarray(OFFSETS[i % len(OFFSETS)] % maxval, jnp.int64)

    def dropout(x, rate, rng):
        if rng is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        return jnp.where(jnp.asarray(pinned_mask(x.shape, keep)), x / keep,
                         0.0)

    mp.setattr(jax.random, "randint", randint)
    mp.setattr(jax.random, "bernoulli",
               lambda key, p=0.5, shape=None: jnp.bool_(flip))
    mp.setattr(jops, "dropout", dropout)
    # the stage steps' index arithmetic mixes Python ints and int32 scalars,
    # which dynamic_slice refuses under x64: one index dtype for all
    mp.setattr(jax.lax, "dynamic_slice", lambda op, idx, sizes: dynamic_slice(
        op, [jnp.asarray(i, jnp.int64) for i in idx], sizes))
    try:
        yield
    finally:
        mp.undo()
        jax.config.update("jax_enable_x64", x64)


class PortDraws:
    """The same pinned draws for the port (monkeypatch utils.rng)."""

    def __init__(self, monkeypatch, flip=True):
        self.calls = 0
        monkeypatch.setattr(trng, "coin", lambda k: flip)
        monkeypatch.setattr(trng, "randint", self._randint)
        monkeypatch.setattr(trng, "bernoulli", lambda k, p, shape, device:
                            torch.from_numpy(pinned_mask(shape, p)).to(device))

    def _randint(self, k, low, high):
        i = self.calls
        self.calls += 1
        return OFFSETS[i % len(OFFSETS)] % high

    def step(self, fn, *args):
        self.calls = 0
        return fn(*args)


def f64(tree):
    """A numpy tree -> the port's float64 tensors on the CPU."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float64),
                    tree)


def jf64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def to_numpy(tree):
    """A JAX tree -> numpy, keeping its dict keys and list order."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def leaf_errors(want, got, path=""):
    """[(max|d| / max(1, max|want|), path)] per leaf, walking `want`'s dict
    keys (the two packages order their leaves differently)."""
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        return [e for k in want for e in leaf_errors(want[k], got[k],
                                                     f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        return [e for i, (w, g) in enumerate(zip(want, got))
                for e in leaf_errors(w, g, f"{path}/{i}")]
    w = np.asarray(want, np.float64)
    g = got.detach().double().cpu().numpy()
    assert g.shape == w.shape, (path, g.shape, w.shape)
    return [(float(np.abs(g - w).max() / max(1.0, np.abs(w).max())), path)]


def assert_trees_close(want, got, tol=LEAF_TOL):
    worst = max(leaf_errors(want, got))
    assert worst[0] <= tol, worst
    return worst[0]


def assert_metrics_close(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


# --------------------------------------------------------------------------
# losses, optimizer, scheduler, SWA, train-mode units
# --------------------------------------------------------------------------


def _nan_target(rng, shape):
    t = np.abs(rng.rand(*shape)).astype(np.float32)
    t[..., ::5, ::3] = np.nan
    return t


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    target = _nan_target(rng, (2, 2, 12, 12))
    target[0, 0, :3, :3] = np.nan  # a whole block invalid
    pred = rng.randn(2, 2, 4, 4).astype(np.float32)
    down_j = np.asarray(jlosses.downsample_nanmean(jnp.asarray(target), 4, 3))
    down_t = tlosses.downsample_nanmean(torch.from_numpy(target), 4, 3)
    np.testing.assert_allclose(down_t.numpy(), down_j, rtol=1e-6)
    assert np.isnan(down_t.numpy()[0, 0, 0, 0])
    nm = np.full((4, 4), 0.2, np.float32)
    tl_j = jlosses.log_fold_target(jnp.asarray(down_j), jnp.asarray(nm), 0.1)
    tl_t = tlosses.log_fold_target(down_t, torch.from_numpy(nm), 0.1)
    np.testing.assert_allclose(tl_t.numpy(), np.asarray(tl_j), rtol=1e-6)
    for norm in ("valid_mean", "full_count"):
        want = float(jlosses.masked_mse(jnp.asarray(pred), tl_j,
                                        normalize=norm))
        got = float(tlosses.masked_mse(torch.from_numpy(pred), tl_t,
                                       normalize=norm))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    p = rng.rand(3, 7).astype(np.float32)
    p[0, 0], p[0, 1] = 0.0, 1.0  # clamped
    t = (rng.rand(3, 7) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.bce(torch.from_numpy(p), torch.from_numpy(t))),
        float(jlosses.bce(jnp.asarray(p), jnp.asarray(t))), rtol=1e-6)
    a = rng.randn(3, 40).astype(np.float32)
    b = (0.5 * a + rng.randn(3, 40)).astype(np.float32)
    b[0, ::4] = np.nan
    b[2, :30] = np.nan  # under the 30%-valid gate
    np.testing.assert_allclose(
        tlosses.pearson_r_per_sample(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy(),
        np.asarray(jlosses.pearson_r_per_sample(jnp.asarray(a),
                                                jnp.asarray(b))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tlosses.pearson_r(torch.from_numpy(a[0]),
                                torch.from_numpy(b[0]))),
        float(jlosses.pearson_r(jnp.asarray(a[0]), jnp.asarray(b[0]))),
        rtol=1e-5)


def test_sgd_matches_optax_trace():
    rng = np.random.RandomState(1)
    params = {"a": [rng.randn(3, 4)], "b": {32: rng.randn(5)}}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape), params)
             for _ in range(3)]
    jopt = joptim.sgd(0.98)
    with jax_pinned():
        jp = jf64(params)
        js = jopt.init(jp)
        for g in grads:
            jp, js = joptim.apply_sgd(jopt, jp, js, jf64(g), jnp.float32(2e-3))
        jp, jtrace = to_numpy(jp), to_numpy(js.trace)
    topt = toptim.sgd(0.98)
    tp = f64(params)
    ts = topt.init(tp)
    for g in grads:
        tp, ts = toptim.apply_sgd(topt, tp, ts, f64(g), 2e-3)
    assert max(leaf_errors(jp, tp))[0] <= 1e-15
    assert max(leaf_errors(jtrace, ts["trace"]))[0] <= 1e-15


def test_plateau_scheduler_matches_jax():
    metrics = [0.5, 0.4, 0.4, 0.9, 0.9, 0.8, 0.95, 0.1, 0.1]
    j = joptim.ReduceLROnPlateau(lr=1.0, factor=0.5, patience=1)
    t = toptim.ReduceLROnPlateau(lr=1.0, factor=0.5, patience=1)
    assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]
    assert t.state_dict() == j.state_dict()
    u = toptim.ReduceLROnPlateau(lr=0.0)
    u.load_state_dict(t.state_dict())
    assert u.state_dict() == t.state_dict()


def test_swa_average_matches_jax():
    rng = np.random.RandomState(2)
    p0 = {"w": rng.randn(3), "v": [rng.randn(2, 2)]}
    ps = [jax.tree.map(lambda x: rng.randn(*x.shape), p0) for _ in range(3)]
    js = jswa.swa_init(jax.tree.map(jnp.asarray, p0))
    ts = tswa.swa_init(tree_map(torch.from_numpy, p0))
    for p in ps:
        js = jswa.swa_update(js, jax.tree.map(jnp.asarray, p))
        ts = tswa.swa_update(ts, tree_map(torch.from_numpy, p))
    assert ts["n"] == int(js["n"]) == 3
    assert max(leaf_errors(to_numpy(js["avg"]), ts["avg"]))[0] <= 1e-6
    carried = swa_state_from_numpy(to_numpy(js), device="cpu")
    assert carried["n"] == 3
    assert max(leaf_errors(to_numpy(js["avg"]), carried["avg"]))[0] == 0


def test_batchnorm_train_two_pass_and_unbiased():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 9, 7, 5) * 0.01 + 1000.0).astype(np.float64)
    scale, bias = rng.rand(5) + 0.5, rng.randn(5)
    y, mean, var, var_u = tops.batchnorm_train(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    flat = x.reshape(-1, 5)
    np.testing.assert_allclose(mean.numpy(), flat.mean(0), rtol=1e-14)
    np.testing.assert_allclose(var.numpy(), flat.var(0), rtol=1e-9)
    np.testing.assert_allclose(var_u.numpy(), flat.var(0, ddof=1), rtol=1e-9)
    want = (x - flat.mean(0)) / np.sqrt(flat.var(0) + 1e-5) * scale + bias
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-8, atol=1e-8)


def test_bn_updates_record_and_merge():
    """A train-mode tower forward records one update per BatchNorm unit,
    with torch's momentum rule; merging writes them into a copy."""
    gen = torch.Generator().manual_seed(0)
    params = tenc.init_encoder_tower(gen)
    x = torch.rand(2, 8000, 4, generator=gen)
    bn = tcore.BNUpdates()
    tenc.apply_encoder_stages(params, x, train=True, rng=trng.key(1),
                              bn_updates=bn, path="encoder")
    assert len(bn.updates) == 7 * 2 * 2
    merged = tcore.merge_bn_updates({"encoder": params}, bn)
    m0 = merged["encoder"]["lconv"][0][0]["bn"]["mean"]
    assert m0.abs().max() > 0 and not m0.requires_grad
    assert params["lconv"][0][0]["bn"]["mean"].abs().max() == 0
    # int-keyed dicts (decoder levels) are addressed by their digits
    tree = {"decoders": {32: [[{"bn": {"mean": 0, "var": 1}}]]}}
    upd = tcore.BNUpdates()
    upd.record("decoders/32/0/0", 5, 6)
    out = tcore.merge_bn_updates(tree, upd)
    assert out["decoders"][32][0][0]["bn"] == {"mean": 5, "var": 6}
    assert tree["decoders"][32][0][0]["bn"] == {"mean": 0, "var": 1}


def test_dropout_needs_a_key_or_mask():
    unit = tcore.Unit(2, 3, 4, k=3, dropout=0.1, bn=False)
    p = tcore._init_unit(torch.Generator().manual_seed(0), unit)
    x = torch.ones(1, 5, 5, 3)
    with pytest.raises(ValueError, match="rng"):
        tcore.apply_unit(p, unit, x, train=True)
    # the mask is the key's bernoulli draw, the same at every call
    keep = trng.bernoulli(11, 0.9, x.shape, "cpu")
    out = tcore.apply_unit(p, unit, x, train=True, rng=11)
    torch.testing.assert_close(out, tcore.apply_unit(p, unit, x, train=True,
                                                     rng=11))
    want = tops.conv2d(torch.where(keep, x / 0.9, 0.0), p["w"], p["b"])
    torch.testing.assert_close(out, want)
    # inference: dropout is the identity
    torch.testing.assert_close(
        tcore.apply_unit(p, unit, x),
        tcore.apply_unit(p, unit, x, train=False, rng=11))


def test_port_draws_statistics():
    """The port's own draws: dropout keeps 0.9 of the entries, zoom offsets
    cover [0, half) and nothing else, the flip is a fair coin; keys split
    apart, and a mask is a pure function of its key."""
    masks = torch.stack([trng.bernoulli(k, 0.9, (4, 32, 32, 64), "cpu")
                         for k in trng.split(trng.key(7), 4)])
    assert abs(masks.float().mean().item() - 0.9) < 0.002
    assert not torch.equal(masks[0], masks[1])
    assert torch.equal(trng.bernoulli(5, 0.9, (64,), "cpu"),
                       trng.bernoulli(5, 0.9, (64,), "cpu"))
    offs = [trng.randint(k, 0, 125) for k in trng.split(trng.key(8), 5000)]
    assert min(offs) == 0 and max(offs) == 124
    assert len(set(offs)) == 125
    flips = [trng.coin(k) for k in trng.split(trng.key(9), 4000)]
    assert abs(np.mean(flips) - 0.5) < 0.03
    keys = trng.split(trng.key(10), 3)
    assert len(set(keys)) == 3 and all(0 <= k < 2 ** 64 for k in keys)
    assert trng.split(keys[0], 2) == trng.split(keys[0], 2)


# --------------------------------------------------------------------------
# stage a against the JAX package
# --------------------------------------------------------------------------

SEQ_A = 40_000
CROP_A = 10
# (id, num_1d, num_2d, port remat)
CASES_A = [("tracks", 4, 1, True), ("two_heads", None, 2, False)]


def _stage_a_inputs(case):
    _, num_1d, num_2d, _ = case
    rng = np.random.RandomState(11 + num_2d)
    params = numpy_tree(tdec.net_spec(num_1d, num_2d), rng)
    lead = (2,) if num_2d == 1 else (2, num_2d)
    nm = np.full((CROP_A, CROP_A), 0.1)
    return dict(
        params=params,
        seq=rng.rand(2, SEQ_A, 4),
        target=_nan_target(rng, lead + (4 * CROP_A, 4 * CROP_A)),
        target_1d=((rng.rand(2, CROP_A, num_1d) > 0.5) if num_1d
                   else np.zeros((2, CROP_A, 0))).astype(np.float64),
        normmat=nm if num_2d == 1 else np.stack([nm, 2 * nm]),
        eps=0.1,
    )


def _jax_stage_a(case):
    """Two JAX steps from zero momentum, then the eval on the result."""
    _, num_1d, num_2d, _ = case
    d = _stage_a_inputs(case)
    cfg = jst.StageAConfig(num_1d=num_1d, num_2d=num_2d, crop=CROP_A,
                           target_factor=4, seq_len=SEQ_A, remat=False)
    opt, step = jst.make_stage_a_step(cfg)
    params = jf64(d["params"])
    state = opt.init(params)
    args = [jnp.asarray(d[k], jnp.float64)
            for k in ("seq", "target", "target_1d")]
    out = []
    for i in range(2):
        params, state, metrics = jax_trace(
            step, params, state, *args, jax.random.PRNGKey(i),
            jnp.float32(0.002), jnp.asarray(d["normmat"], jnp.float64),
            d["eps"])
        out.append((to_numpy(params), to_numpy(state.trace),
                    {k: float(v) for k, v in metrics.items()}))
    corr, mse, bce = jax.jit(jst.stage_a_eval_metrics, static_argnums=1)(
        params, cfg, args[0], args[1], args[2],
        jnp.asarray(d["normmat"], jnp.float64), d["eps"])
    return out, (np.asarray(corr), float(mse), float(bce))


@pytest.fixture(scope="module")
def jax_stage_a():
    with jax_pinned(), ThreadPoolExecutor(len(CASES_A)) as ex:
        futures = {c[0]: ex.submit(_jax_stage_a, c) for c in CASES_A}
        return {k: f.result() for k, f in futures.items()}


@pytest.mark.parametrize("case", CASES_A, ids=[c[0] for c in CASES_A])
def test_stage_a_two_steps_match_jax(jax_stage_a, case, monkeypatch):
    name, num_1d, num_2d, remat = case
    draws = PortDraws(monkeypatch)
    d = _stage_a_inputs(case)
    cfg = tst.StageAConfig(num_1d=num_1d, num_2d=num_2d, crop=CROP_A,
                           target_factor=4, seq_len=SEQ_A, remat=remat)
    opt, step = tst.make_stage_a_step(cfg, device="cpu")
    params = f64(d["params"])
    state = opt.init(params)
    args = [f64(d[k]) for k in ("seq", "target", "target_1d")]
    want, want_eval = jax_stage_a[name]
    for i in range(2):
        params, state, metrics = draws.step(
            step, params, state, *args, trng.key(i), 0.002,
            f64(d["normmat"]), d["eps"])
        want_params, want_trace, want_metrics = want[i]
        assert_metrics_close(want_metrics, metrics)
        assert_trees_close(want_params, params)
        assert_trees_close(want_trace, state["trace"])
    # validation: the port folds a copy, so its tower runs the fused
    # kernels' plain versions; the JAX package runs its unfolded tower
    corr, mse, bce = tst.stage_a_eval_metrics(
        params, cfg, *args, f64(d["normmat"]), d["eps"])
    np.testing.assert_allclose(corr.numpy(), want_eval[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(mse), want_eval[1], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(bce), want_eval[2], rtol=LOSS_RTOL)


def test_stage_a_carries_the_jax_momentum(jax_stage_a, monkeypatch):
    """A step of the port started from the JAX package's params and
    momentum after its first step gives the JAX package's second step."""
    case = CASES_A[0]
    draws = PortDraws(monkeypatch)
    d = _stage_a_inputs(case)
    cfg = tst.StageAConfig(num_1d=4, crop=CROP_A, target_factor=4,
                           seq_len=SEQ_A, remat=False)
    _, step = tst.make_stage_a_step(cfg, device="cpu")
    first, second = jax_stage_a["tracks"][0]
    state = opt_state_from_numpy({"trace": first[1]}, device="cpu",
                                 dtype=torch.float64)
    params, state, metrics = draws.step(
        step, f64(first[0]), state,
        *[f64(d[k]) for k in ("seq", "target", "target_1d")], trng.key(1),
        0.002, f64(d["normmat"]), d["eps"])
    assert_metrics_close(second[2], metrics)
    assert_trees_close(second[1], state["trace"])


# --------------------------------------------------------------------------
# remat and the BN-refresh of SWA (port only)
# --------------------------------------------------------------------------


def _grads_of(step, *args):
    """The momentum tree after one step from zero momentum: the gradient."""
    _, state, metrics = step(*args)
    return state["trace"], metrics


@pytest.mark.parametrize("num_1d", [4, None], ids=["tracks", "no_tracks"])
def test_stage_a_remat_equals_no_remat(num_1d):
    """The checkpointed segments (the tower, the 2D stack, whose dropout
    mask the recompute draws again from its key) give the gradients of the
    plain forward, under the same (real) draws."""
    gen = torch.Generator().manual_seed(3)
    params = tdec.init_net(gen, num_1d=num_1d)
    seq = torch.rand(2, SEQ_A, 4, generator=gen)
    target = torch.rand(2, 4 * CROP_A, 4 * CROP_A, generator=gen)
    t1d = (torch.rand(2, CROP_A, num_1d or 0, generator=gen) > 0.5).float()
    out = []
    for remat in (False, True):
        cfg = tst.StageAConfig(num_1d=num_1d, crop=CROP_A, target_factor=4,
                               seq_len=SEQ_A, remat=remat)
        opt, step = tst.make_stage_a_step(cfg, device="cpu")
        out.append(_grads_of(step, params, opt.init(params), seq, target,
                             t1d, trng.key(4), 0.002,
                             torch.full((CROP_A, CROP_A), 0.1), 0.1))
    (g0, m0), (g1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


def test_swa_bn_refresh_moves_only_running_stats():
    gen = torch.Generator().manual_seed(5)
    params = tdec.init_net(gen, num_1d=None)
    cfg = tst.StageAConfig(num_1d=None, crop=CROP_A, target_factor=4,
                           seq_len=SEQ_A)
    new = tswa.swa_forward_update_bn(tswa.swa_init(params), cfg,
                                     torch.rand(2, SEQ_A, 4, generator=gen),
                                     trng.key(1))
    before = params["encoder"]["lconv"][0][0]
    after = new["avg"]["encoder"]["lconv"][0][0]
    assert not torch.allclose(before["bn"]["mean"], after["bn"]["mean"])
    assert torch.equal(before["w"], after["w"])
    assert new["n"] == 0
