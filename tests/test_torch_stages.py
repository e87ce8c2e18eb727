"""The port's stage-b steps and evals (orca_tpu_torch.training.stages)
against orca_tpu.training.stages, in float64 with pinned draws (see
test_torch_training.py for why, and for the bars).

Geometry of the JAX package's own tests, CascadeGeometry(1_024_000, 4000,
8), with levels (32, 1) single-head, (32, 1) with two heads and no up-pass
(the leukemia pyramid), and (32, 16). Both packages' steps take the same
seeded features in place of the frozen tower (`encoder_fn`): the tower's
parity is test_torch_encoders.py's, and the port's steps run it in
test_torch_loop.py, test_torch_launch.py and the remat test below. The JAX
programs are built once per module and compiled concurrently.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_tpu.models.zoo import _random_normmats
from orca_tpu.predict.multiscale import CascadeGeometry as JGeom
from orca_tpu.training import stages as jst
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.predict.multiscale import CascadeGeometry as TGeom
from orca_tpu_torch.training import stages as tst
from orca_tpu_torch.utils import rng as trng
from orca_tpu_torch.utils.tree import tree_leaves
from test_torch_encoders import numpy_tree
from test_torch_training import (
    LOSS_RTOL,
    PortDraws,
    assert_metrics_close,
    assert_trees_close,
    f64,
    jax_pinned,
    jax_trace,
    jf64,
    to_numpy,
)

B_GEOM = (1_024_000, 4000, 8)
# (id, levels, num_2d, up_pass, port remat, eval)
CASES_B = [
    ("32_1", (32, 1), 1, True, True, True),
    ("32_1_two_heads_no_up_pass", (32, 1), 2, False, False, True),
    ("32_16", (32, 16), 1, True, True, False),
]


def _frozen_1pt(rng, num_2d):
    """The frozen Decoder_1m head, folded, as numpy."""
    return fold_params(f64(numpy_tree(tdec.decoder1m_spec(num_2d), rng)),
                       tdec.decoder1m_spec(num_2d))


def _stage_b_inputs(case):
    _, levels, num_2d, up_pass, _, _ = case
    rng = np.random.RandomState(20 + len(levels) + num_2d)
    geom = TGeom(*B_GEOM)
    trainable = {
        "pyramid": numpy_tree(tenc.pyramid_spec(5, up_pass), rng),
        "decoders": {lv: numpy_tree(tdec.decoder_spec(num_2d), rng)
                     for lv in levels},
    }
    decoder_1pt = tree_np(_frozen_1pt(rng, num_2d))
    if num_2d == 1:
        nms, epss = _random_normmats(levels=levels, nbins=geom.bins,
                                     crop=geom.crop)
    else:
        from orca_tpu.models.zoo import multi_normmats_from_expectations

        d = np.arange(geom.bins, dtype=np.float64)
        nms, epss = multi_normmats_from_expectations(
            [-1.5 * np.log1p(d) - 2.0, -1.4 * np.log1p(d) - 2.1],
            levels=levels, nbins=geom.bins, crop=geom.crop)
    lead = (2,) if num_2d == 1 else (2, num_2d)
    target = np.abs(rng.rand(*lead, geom.bins, geom.bins))
    target[..., ::7, ::5] = np.nan
    return dict(
        trainable=trainable, decoder_1pt=decoder_1pt,
        feats=rng.randn(2, geom.bins, 128),
        seq=np.zeros((2, 8, 4)),  # only its batch size is read
        target=target,
        normmats=np.stack([nms[lv] for lv in levels]),
        epss=np.array([epss[lv] for lv in levels]),
    )


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_np(v) for v in tree]
    return tree.numpy()


def _jax_stage_b(case):
    _, levels, num_2d, up_pass, _, with_eval = case
    d = _stage_b_inputs(case)
    feats = jnp.asarray(d["feats"], jnp.float64)
    cfg = jst.StageBConfig(geometry=JGeom(*B_GEOM), encoder_block_bp=None,
                           levels=levels, num_2d=num_2d, up_pass=up_pass,
                           remat=False)
    opt, step = jst.make_stage_b_step(cfg, encoder_fn=lambda p, s: feats)
    trainable = jf64(d["trainable"])
    frozen = {"encoder": {}, "decoder_1pt": jf64(d["decoder_1pt"])}
    state = opt.init(trainable)
    args = [jnp.asarray(d[k], jnp.float64) for k in ("seq", "target")]
    nm = [jnp.asarray(d[k], jnp.float64) for k in ("normmats", "epss")]
    out = []
    for i in range(2):
        trainable, state, metrics = jax_trace(
            step, trainable, frozen, state, *args, jax.random.PRNGKey(i),
            jnp.float32(0.002), *nm)
        out.append((to_numpy(trainable), to_numpy(state.trace),
                    {k: float(v) for k, v in metrics.items()}))
    ev = None
    if with_eval:
        evaluate = jst.make_stage_b_eval(cfg, encoder_fn=lambda p, s: feats)
        mses, corrs = evaluate(trainable, frozen, *args, *nm)
        ev = ({lv: float(v) for lv, v in mses.items()},
              {lv: np.asarray(v) for lv, v in corrs.items()})
    return out, ev


@pytest.fixture(scope="module")
def jax_runs():
    with jax_pinned(), ThreadPoolExecutor(len(CASES_B)) as ex:
        futures = {c[0]: ex.submit(_jax_stage_b, c) for c in CASES_B}
        return {k: f.result() for k, f in futures.items()}


def _feats_fn(feats):
    t = f64(feats)
    return lambda p, s: t[: s.shape[0]]


def _assert_eval(want, mses, corrs):
    want_mses, want_corrs = want
    assert set(mses) == set(want_mses)
    for lv in want_mses:
        np.testing.assert_allclose(float(mses[lv]), want_mses[lv],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(corrs[lv].numpy(), want_corrs[lv],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", CASES_B, ids=[c[0] for c in CASES_B])
def test_stage_b_two_steps_and_eval_match_jax(jax_runs, case, monkeypatch):
    name, levels, num_2d, up_pass, remat, with_eval = case
    draws = PortDraws(monkeypatch)
    d = _stage_b_inputs(case)
    cfg = tst.StageBConfig(geometry=TGeom(*B_GEOM), encoder_block_bp=None,
                           levels=levels, num_2d=num_2d, up_pass=up_pass,
                           remat=remat)
    feats_fn = _feats_fn(d["feats"])
    opt, step = tst.make_stage_b_step(cfg, encoder_fn=feats_fn, device="cpu")
    trainable = f64(d["trainable"])
    frozen = {"encoder": {}, "decoder_1pt": f64(d["decoder_1pt"])}
    state = opt.init(trainable)
    args = [f64(d[k]) for k in ("seq", "target")]
    nm = [f64(d[k]) for k in ("normmats", "epss")]
    want, want_eval = jax_runs[name]
    for i in range(2):
        trainable, state, metrics = draws.step(
            step, trainable, frozen, state, *args, trng.key(i), 0.002, *nm)
        want_params, want_trace, want_metrics = want[i]
        assert_metrics_close(want_metrics, metrics)
        assert_trees_close(want_params, trainable)
        assert_trees_close(want_trace, state["trace"])
    if with_eval:
        evaluate = tst.make_stage_b_eval(cfg, encoder_fn=feats_fn,
                                         device="cpu")
        _assert_eval(want_eval, *evaluate(trainable, frozen, *args, *nm))


def test_stage_b_remat_equals_no_remat():
    """Per-block checkpoints (dropout masks drawn before each) give the
    gradients of the plain forward under the same real draws, float32, with
    the frozen tower folded on the port's default path."""
    gen = torch.Generator().manual_seed(6)
    levels = (32, 1)
    trainable = {"pyramid": tenc.init_pyramid(gen, 5, True),
                 "decoders": {lv: tdec.init_decoder(gen) for lv in levels}}
    frozen = {
        "encoder": fold_params(tenc.init_encoder_tower(gen),
                               tenc.encoder_tower_spec()),
        "decoder_1pt": fold_params(tdec.init_decoder1m(gen),
                                   tdec.decoder1m_spec(1)),
    }
    geom = TGeom(*B_GEOM)
    seq = (torch.eye(4, dtype=torch.uint8)[
        torch.randint(0, 4, (1, geom.window_bp), generator=gen)] * 4)
    target = torch.rand(1, geom.bins, geom.bins, generator=gen)
    nms, epss = _random_normmats(levels=levels, nbins=geom.bins,
                                 crop=geom.crop)
    nm = torch.tensor(np.stack([nms[lv] for lv in levels]),
                      dtype=torch.float32)
    ep = torch.tensor([epss[lv] for lv in levels], dtype=torch.float32)
    feats = tenc.apply_encoder_tower(frozen["encoder"], seq)
    out = []
    for remat in (False, True):
        cfg = tst.StageBConfig(geometry=geom, encoder_block_bp=None,
                               levels=levels, remat=remat)
        opt, step = tst.make_stage_b_step(
            cfg, encoder_fn=None if remat else (lambda p, s: feats),
            device="cpu")
        _, state, metrics = step(trainable, frozen, opt.init(trainable), seq,
                                 target, trng.key(2), 0.002, nm, ep)
        out.append((state["trace"], metrics))
    (g0, m0), (g1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
