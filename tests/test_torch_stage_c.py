"""The port's stage-c step and eval (orca_tpu_torch.training.stages)
against orca_tpu.training.stages, in float64 with pinned draws (see
test_torch_training.py for why, and for the bars).

Geometry of the JAX package's tests/test_stage_c.py: a 2.048 Mb window of
32 kb bins (crop 2) with all four levels, two windows a step (with one,
BatchNorm's batch is 2 x 2 positions and a 1e-15 change of the input moves
the float64 gradient by 6e-7 of max(1, max|g|): no parity can be seen
there; with two it moves it by 1e-11). Both packages' steps take the same
seeded features in place of the frozen tower (`encoder_fn`).

The second step is far worse conditioned than the first: a 1e-15 relative
change of the initial params moves the second step's momentum by 8e-8 of
max(1, max|g|) (the port alone, measured), so the two packages' ~1e-11
rounding differences after step one grow to ~2e-7 after step two. Run from
the JAX package's own state after step one, the port's second step agrees
with JAX's to ~6e-11: the test holds it to 1e-9 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orca_tpu.predict.multiscale import CascadeGeometry as JGeom
from orca_tpu.training import stages as jst
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.predict.multiscale import CascadeGeometry as TGeom
from orca_tpu_torch.training import stages as tst
from orca_tpu_torch.utils import rng as trng
from test_torch_encoders import numpy_tree
from test_torch_stages import _assert_eval, _feats_fn, tree_np
from test_torch_training import (
    PortDraws,
    assert_metrics_close,
    assert_trees_close,
    f64,
    jax_pinned,
    jax_trace,
    jf64,
    to_numpy,
)

C_GEOM = (2_048_000, 32_000, 2)
C_LEVELS = (256, 128, 64, 32)
STEP_FROM_JAX_TOL = 1e-9


def _c_normmat(bins, n):
    """Per-sample distance-decay backgrounds, NaN-free (as the trainer fills
    them), a little different per sample."""
    dist = np.abs(np.arange(bins)[None, :] - np.arange(bins)[:, None])
    base = np.exp(-1.2 * np.log1p(dist) - 3.0)
    return np.stack([base * (1 + 0.1 * i) for i in range(n)])


def _stage_c_inputs():
    rng = np.random.RandomState(30)
    geom = TGeom(*C_GEOM)
    trainable = {
        "pyramid": numpy_tree(tenc.pyramid_spec(3, True), rng),
        "decoders": {lv: numpy_tree(tdec.decoder_spec(1), rng)
                     for lv in C_LEVELS},
    }
    pyramid1 = tree_np(fold_params(
        f64(numpy_tree(tenc.pyramid_spec(5, True), rng)),
        tenc.pyramid_spec(5, True)))
    target = np.abs(rng.rand(2, geom.bins, geom.bins))
    target[:, ::5, ::3] = np.nan
    return dict(trainable=trainable, pyramid1=pyramid1,
                feats=rng.randn(2, geom.window_bp // 4000, 128),
                seq=np.zeros((2, 8, 4)), target=target,
                normmat=_c_normmat(geom.bins, 2))


def _jax_stage_c():
    d = _stage_c_inputs()
    cfg = jst.StageCConfig(geometry=JGeom(*C_GEOM), levels=C_LEVELS,
                           encoder_block_bp=None, remat=False)
    feats = jnp.asarray(d["feats"], jnp.float64)
    opt, step = jst.make_stage_c_step(cfg, encoder_fn=lambda p, s: feats)
    trainable = jf64(d["trainable"])
    frozen = {"encoder": {}, "pyramid1": jf64(d["pyramid1"])}
    state = opt.init(trainable)
    args = [jnp.asarray(d[k], jnp.float64)
            for k in ("seq", "target", "normmat")]
    out = []
    for i in range(2):
        trainable, state, metrics = jax_trace(
            step, trainable, frozen, state, *args, jax.random.PRNGKey(i),
            jnp.float32(0.002))
        out.append((to_numpy(trainable), to_numpy(state.trace),
                    {k: float(v) for k, v in metrics.items()}))
    evaluate = jst.make_stage_c_eval(cfg, encoder_fn=lambda p, s: feats)
    mses, corrs = evaluate(trainable, frozen, *args)
    return out, ({lv: float(v) for lv, v in mses.items()},
                 {lv: np.asarray(v) for lv, v in corrs.items()})


@pytest.fixture(scope="module")
def jax_run():
    with jax_pinned():
        return _jax_stage_c()


def test_stage_c_two_steps_and_eval_match_jax(jax_run, monkeypatch):
    draws = PortDraws(monkeypatch)
    d = _stage_c_inputs()
    cfg = tst.StageCConfig(geometry=TGeom(*C_GEOM), levels=C_LEVELS,
                           encoder_block_bp=None)
    feats_fn = _feats_fn(d["feats"])
    opt, step = tst.make_stage_c_step(cfg, encoder_fn=feats_fn, device="cpu")
    trainable = f64(d["trainable"])
    frozen = {"encoder": {}, "pyramid1": f64(d["pyramid1"])}
    state = opt.init(trainable)
    args = [f64(d[k]) for k in ("seq", "target", "normmat")]
    want, want_eval = jax_run
    for i in range(2):
        trainable, state, metrics = draws.step(
            step, trainable, frozen, state, *args, trng.key(i), 0.002)
        want_params, want_trace, want_metrics = want[i]
        assert_metrics_close(want_metrics, metrics)
        assert_trees_close(want_params, trainable)
        assert_trees_close(want_trace, state["trace"])
    # step two again, from the JAX package's state after step one
    params1, state1, metrics1 = draws.step(
        step, f64(want[0][0]), frozen, {"trace": f64(want[0][1])}, *args,
        trng.key(1), 0.002)
    assert_metrics_close(want[1][2], metrics1)
    assert_trees_close(want[1][0], params1, tol=STEP_FROM_JAX_TOL)
    assert_trees_close(want[1][1], state1["trace"], tol=STEP_FROM_JAX_TOL)
    evaluate = tst.make_stage_c_eval(cfg, encoder_fn=feats_fn, device="cpu")
    _assert_eval(want_eval, *evaluate(trainable, frozen, *args))
