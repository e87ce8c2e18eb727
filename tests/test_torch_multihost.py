"""Data-parallel training steps in the port (parallel/multihost.py, the
data group through BatchNorm, dropout, the losses and the steps) against the
JAX package's mesh steps and the port's own one-process step.

The ranks are subprocesses, `python tests/test_torch_multihost.py <mode>
...`, with gloo on localhost: they import neither jax nor the conftest, and
this module imports jax only inside the tests (the modes: `steps` below;
`launch` and `nccl` for test_torch_multihost_launch.py).

`steps` (2 ranks): the multihost helpers; one float64 stage-a, stage-b and
stage-c step each with pinned draws, every rank on its half of the global
batch, held to the JAX package's step on a make_mesh((2, 1)) mesh of CPU
devices from the same numpy inputs (the JAX programs compile meanwhile);
the two halves of each target hold different NaN counts, so a per-rank mean
would miss, and stage c's per-sample backgrounds differ, so a per-rank eps
would. Then a dp x sp stage-b step with the port's own draws: each rank's
row through the real frozen tower sharded over a row of the CPU named twice
(two 448 kb shards of an 896 kb window, PR 11's tower geometry), held to
the one-process step on the whole batch. After every step each rank checks
that all ranks hold the same bits of the state.

Bar: TOL = 1e-9 * max(1, max|ref|) on every leaf and metric, float64: only
the reduction order differs (2e-12 worst, measured).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL = 1e-9
OFFSETS = (3, 1, 2, 0)  # pinned zoom offsets, as test_torch_training's

SEQ_A, CROP_A = 40_000, 10
B_GEOM, B_LEVELS = (1_024_000, 4000, 8), (32,)
C_GEOM, C_LEVELS = (2_048_000, 32_000, 2), (256,)
SP_GEOM, SP_LEVELS = (896_000, 4000, 7), (32,)  # two 448 kb shards


# --------------------------------------------------------------------------
# inputs and draws, shared by the test and the ranks (numpy and torch only)
# --------------------------------------------------------------------------


def pinned_mask(shape, keep):
    """test_torch_training.pinned_mask: a keep-mask of the shape alone."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).rand(*shape) < keep


def numpy_tree(spec, rng):
    """test_torch_encoders.numpy_tree (which imports jax): a parameter tree
    for a spec, torch's conv init law, non-trivial BatchNorm statistics."""
    if hasattr(spec, "units"):
        return [numpy_tree(u, rng) for u in spec.units]
    if hasattr(spec, "cin"):
        shape = (spec.k,) * spec.dim + (spec.cin, spec.cout)
        lim = 1.0 / np.sqrt(spec.cin * spec.k ** spec.dim)
        p = {"w": rng.uniform(-lim, lim, shape).astype(np.float32),
             "b": rng.uniform(-lim, lim, spec.cout).astype(np.float32)}
        if spec.bn:
            c = spec.cout
            p["bn"] = {
                "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
            }
        return p
    if isinstance(spec, dict):
        return {k: numpy_tree(v, rng) for k, v in spec.items()}
    return [numpy_tree(s, rng) for s in spec]


def _normmats(levels, bins, crop):
    from orca_tpu_torch.models.zoo import normmats_from_expectation

    d = np.arange(bins, dtype=np.float64)
    nms, epss = normmats_from_expectation(-1.5 * np.log1p(d) - 2.0,
                                          levels=levels, nbins=bins,
                                          crop=crop)
    return (np.stack([nms[lv] for lv in levels]),
            np.array([epss[lv] for lv in levels]))


def _unequal_nans(target, block):
    """Row 0 loses half its rows of `block`-bin blocks, row 1 one block:
    the halves of the global batch hold different valid counts."""
    target[0, ..., : target.shape[-2] // 2, :] = np.nan
    target[1, ..., :block, :block] = np.nan
    return target


def inputs(stage):
    """The numpy inputs of one stage's step (seeded)."""
    from orca_tpu_torch.nn import decoders as tdec
    from orca_tpu_torch.nn import encoders as tenc

    rng = np.random.RandomState({"a": 41, "b": 42, "c": 43, "sp": 44}[stage])
    if stage == "a":
        return dict(
            params=numpy_tree(tdec.net_spec(4, 1), rng),
            seq=rng.rand(2, SEQ_A, 4),
            target=_unequal_nans(np.abs(rng.rand(2, 4 * CROP_A, 4 * CROP_A)),
                                 4),
            target_1d=(rng.rand(2, CROP_A, 4) > 0.5).astype(np.float64),
            normmat=np.full((CROP_A, CROP_A), 0.1), eps=0.1)
    geom, levels, pyr = {"b": (B_GEOM, B_LEVELS, 5),
                         "c": (C_GEOM, C_LEVELS, 3),
                         "sp": (SP_GEOM, SP_LEVELS, 5)}[stage]
    window, bin_bp, crop = geom
    bins = window // bin_bp
    d = dict(trainable={
        "pyramid": numpy_tree(tenc.pyramid_spec(pyr, True), rng),
        "decoders": {lv: numpy_tree(tdec.decoder_spec(1), rng)
                     for lv in levels}})
    d["target"] = _unequal_nans(np.abs(rng.rand(2, bins, bins)),
                                bins // crop)
    if stage == "c":
        dist = np.abs(np.arange(bins)[None] - np.arange(bins)[:, None])
        base = np.exp(-1.2 * np.log1p(dist) - 3.0)
        d.update(pyramid1=numpy_tree(tenc.pyramid_spec(5, True), rng),
                 feats=rng.randn(2, window // 4000, 128),
                 normmat=np.stack([base, 1.1 * base]))
        return d
    d["normmats"], d["epss"] = _normmats(levels, bins, crop)
    if stage == "b":
        d["feats"] = rng.randn(2, bins, 128)
    else:
        d["tower"] = numpy_tree(tenc.encoder_tower_spec(), rng)
        d["seq"] = (np.eye(4, dtype=np.uint8)[rng.randint(0, 4, (2, window))]
                    * 4)
    return d


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def t64(tree):
    from orca_tpu_torch.utils.tree import tree_map

    return tree_map(lambda a: torch.tensor(np.asarray(a),
                                           dtype=torch.float64), tree)


class PinnedDraws:
    """test_torch_training.PortDraws without pytest: utils.rng's coin,
    randint and bernoulli pinned (bernoulli by the mask's shape) until
    `undo`."""

    def __init__(self):
        from orca_tpu_torch.utils import rng as trng

        self.trng, self.calls = trng, 0
        self.saved = {n: getattr(trng, n)
                      for n in ("coin", "randint", "bernoulli")}
        trng.coin = lambda k: True
        trng.randint = self._randint
        trng.bernoulli = lambda k, p, shape, device: torch.from_numpy(
            pinned_mask(shape, p)).to(device)

    def _randint(self, k, low, high):
        self.calls += 1
        return OFFSETS[(self.calls - 1) % len(OFFSETS)] % high

    def step(self, fn, *args):
        self.calls = 0
        return fn(*args)

    def undo(self):
        for n, f in self.saved.items():
            setattr(self.trng, n, f)


# --------------------------------------------------------------------------
# the port's steps (a rank, or the one-process reference)
# --------------------------------------------------------------------------


def _geom(g):
    from orca_tpu_torch.predict.multiscale import CascadeGeometry

    return CascadeGeometry(*g)


def port_step(stage, group=None, mesh=None, draws=None, device="cpu"):
    """One float64 step of `stage` on this rank's rows (all rows without a
    group): (params, momentum, metrics) as numpy. Stage a may run on a CUDA
    `device`."""
    from orca_tpu_torch.nn import encoders as tenc
    from orca_tpu_torch.nn.core import fold_params
    from orca_tpu_torch.training import loop as tloop
    from orca_tpu_torch.training import stages as tst
    from orca_tpu_torch.utils import rng as trng
    from orca_tpu_torch.utils.tree import tree_map

    d = inputs(stage)
    rows = (slice(None) if group is None
            else slice(group.rank, group.rank + 1))
    run = draws.step if draws is not None else (lambda fn, *a: fn(*a))
    key, lr = trng.key(5), 0.002
    if stage == "a":
        cfg = tst.StageAConfig(num_1d=4, crop=CROP_A, target_factor=4,
                               seq_len=SEQ_A, remat=True)
        opt, step = tst.make_stage_a_step(cfg, device, group=group)
        params = tree_map(lambda t: t.to(device), t64(d["params"]))
        args = [t64(d[k])[rows].to(device)
                for k in ("seq", "target", "target_1d")]
        params, state, metrics = run(step, params, opt.init(params), *args,
                                     key, lr, t64(d["normmat"]).to(device),
                                     d["eps"])
    elif stage == "c":
        cfg = tst.StageCConfig(geometry=_geom(C_GEOM), levels=C_LEVELS,
                               encoder_block_bp=None)
        feats = t64(d["feats"])[rows]
        opt, step = tst.make_stage_c_step(cfg, lambda p, s: feats, "cpu",
                                          group)
        params = t64(d["trainable"])
        frozen = {"encoder": {}, "pyramid1": fold_params(
            t64(d["pyramid1"]), tenc.pyramid_spec(5, True))}
        params, state, metrics = run(
            step, params, frozen, opt.init(params),
            torch.zeros(feats.shape[0], 8, 4), t64(d["target"])[rows],
            t64(d["normmat"])[rows], key, lr)
    else:
        geom = _geom(B_GEOM if stage == "b" else SP_GEOM)
        cfg = tst.StageBConfig(geometry=geom, encoder_block_bp=None,
                               levels=B_LEVELS, use_1pt=False)
        if stage == "b":
            feats = t64(d["feats"])[rows]
            encoder_fn = lambda p, s: feats  # noqa: E731
            seq = torch.zeros(feats.shape[0], 8, 4)
            frozen = {"encoder": {}}
        else:
            frozen = {"encoder": fold_params(
                tree_map_f32(d["tower"]), tenc.encoder_tower_spec())}
            seq = torch.from_numpy(d["seq"])[rows]
            # the CPU's convs round by batch size: the reference runs the
            # one-device tower a row at a time, as each rank does
            encoder_fn = (tloop._mesh_encoder_fn(mesh, None) if mesh
                          else lambda p, s: torch.cat([
                              tenc.apply_encoder_tower(p, s[i:i + 1])
                              for i in range(s.shape[0])]))
        opt, step = tst.make_stage_b_step(cfg, encoder_fn, "cpu", group)
        params = t64(d["trainable"])
        params, state, metrics = run(
            step, params, frozen, opt.init(params), seq,
            t64(d["target"])[rows], key, lr, t64(d["normmats"]),
            t64(d["epss"]))
    if group is not None:
        group.check_replicas([params, state], f"stage {stage}'s state")
    return (tree_np(params), tree_np(state["trace"]),
            {k: float(v) for k, v in metrics.items()})


def tree_map_f32(tree):
    from orca_tpu_torch.utils.tree import tree_map

    return tree_map(lambda a: torch.tensor(np.asarray(a),
                                           dtype=torch.float32), tree)


# --------------------------------------------------------------------------
# the ranks' entry point
# --------------------------------------------------------------------------


def _rank_steps(outdir):
    from orca_tpu_torch.parallel import multihost

    multihost.initialize(backend="gloo")
    mesh = multihost.make_multihost_mesh(1, device_type="cpu")
    group = mesh.data_group
    rank = group.rank
    x = np.arange(8 * 3).reshape(8, 3)
    sl = multihost.local_batch_slice(8)
    out = {
        "mesh_shape": mesh.shape,
        "slice": (sl.start, sl.stop),
        "shard": multihost.shard_batch(mesh, x).numpy(),
        "own": multihost.shard_batch(mesh, x[:3] + 100 * rank,
                                     global_batch=False).numpy(),
        "gathered": multihost.fetch_global(torch.full((2, 3), rank), mesh),
    }
    draws = PinnedDraws()
    try:
        for stage in ("a", "b", "c"):
            out[stage] = port_step(stage, group, draws=draws)
    finally:
        draws.undo()
    row = multihost.make_multihost_mesh(2, device_type="cpu")
    out["sp"] = port_step("sp", row.data_group, mesh=row)
    out["sp_mesh"] = (row.shape, [str(d) for d in row.devices[0]])
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _launch(job_path, out_path):
    from orca_tpu_torch.training import launch

    job = launch.TrainJob.from_json(job_path)
    metrics = launch.run(job, device="cpu")
    with open(out_path, "w") as f:
        json.dump(metrics, f)


def _rank_nccl(outdir):
    """A float64 stage-a step with the port's own draws on this rank's card
    (nccl), and on rank 0 the one-process step on the whole batch."""
    from orca_tpu_torch.parallel import multihost

    multihost.initialize()
    mesh = multihost.make_multihost_mesh(1)
    group = mesh.data_group
    out = {"dp": port_step("a", group, device=mesh.device()),
           "device": str(mesh.device())}
    if group.rank == 0:
        out["one"] = port_step("a", device=mesh.device())
        with open(os.path.join(outdir, "nccl.pkl"), "wb") as f:
            pickle.dump(out, f)


def main(argv):
    torch.set_num_threads(2)
    mode = argv[0]
    if mode == "steps":
        _rank_steps(argv[1])
    elif mode == "launch":
        _launch(argv[1], argv[2])
    elif mode == "nccl":
        _rank_nccl(argv[1])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the test side
# --------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTEST"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", **extra)
    return env


def start_ranks(mode, *args, world=WORLD):
    """`world` rank subprocesses with torchrun's environment."""
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, *map(str, args)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_env(MASTER_ADDR="localhost", MASTER_PORT=port,
                 WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(world)]


def finish(procs, timeout=600):
    outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-6000:]
    return outs


def leaf_err(want, got):
    """max over leaves of max|d| / max(1, max|want|), walking want's keys."""
    if isinstance(want, dict):
        assert set(want) == set(got)
        return max(leaf_err(want[k], got[k]) for k in want)
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        return max(leaf_err(w, g) for w, g in zip(want, got))
    w, g = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert w.shape == g.shape
    return float(np.abs(w - g).max() / max(1.0, np.abs(w).max()))


def _jax_mesh_step(stage):
    """The JAX package's step on a (2, 1) mesh of CPU devices, float64,
    pinned draws (inside test_torch_training.jax_pinned)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from orca_tpu.nn import encoders as jenc
    from orca_tpu.nn.core import fold_params as jfold
    from orca_tpu.parallel.mesh import make_mesh
    from orca_tpu.predict.multiscale import CascadeGeometry as JGeom
    from orca_tpu.training import stages as jst
    from test_torch_training import jax_trace, jf64, to_numpy

    mesh = make_mesh((WORLD, 1))
    repl = NamedSharding(mesh, P())

    def rows(a):
        a = jnp.asarray(a, jnp.float64)
        return jax.device_put(a, NamedSharding(
            mesh, P("data", *([None] * (a.ndim - 1)))))

    d = inputs(stage)
    key, lr = jax.random.PRNGKey(5), jnp.float32(0.002)
    if stage == "a":
        cfg = jst.StageAConfig(num_1d=4, crop=CROP_A, target_factor=4,
                               seq_len=SEQ_A, remat=False)
        opt, step = jst.make_stage_a_step(cfg)
        params = jax.device_put(jf64(d["params"]), repl)
        out = jax_trace(step, params, opt.init(params),
                        *(rows(d[k]) for k in ("seq", "target", "target_1d")),
                        key, lr, jnp.asarray(d["normmat"], jnp.float64),
                        d["eps"])
    elif stage == "b":
        cfg = jst.StageBConfig(geometry=JGeom(*B_GEOM), levels=B_LEVELS,
                               encoder_block_bp=None, use_1pt=False,
                               remat=False)
        feats = rows(d["feats"])
        opt, step = jst.make_stage_b_step(cfg, encoder_fn=lambda p, s: feats)
        params = jax.device_put(jf64(d["trainable"]), repl)
        out = jax_trace(step, params, {"encoder": {}}, opt.init(params),
                        rows(np.zeros((2, 8, 4))), rows(d["target"]), key,
                        lr, jnp.asarray(d["normmats"], jnp.float64),
                        jnp.asarray(d["epss"], jnp.float64))
    else:
        cfg = jst.StageCConfig(geometry=JGeom(*C_GEOM), levels=C_LEVELS,
                               encoder_block_bp=None, remat=False)
        feats = rows(d["feats"])
        opt, step = jst.make_stage_c_step(cfg, encoder_fn=lambda p, s: feats)
        params = jax.device_put(jf64(d["trainable"]), repl)
        frozen = {"encoder": {}, "pyramid1": jfold(
            jf64(d["pyramid1"]), jenc.pyramid_spec(5, True))}
        out = jax_trace(step, params, frozen, opt.init(params),
                        rows(np.zeros((2, 8, 4))), rows(d["target"]),
                        rows(d["normmat"]), key, lr)
    params, state, metrics = out
    return (to_numpy(params), to_numpy(state.trace),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The `steps` ranks' results (rank 0's and rank 1's), the JAX mesh
    steps computed meanwhile, and the one-process dp x sp reference."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_encoders import share_cpu_with_other_workers
    from test_torch_training import jax_pinned

    share_cpu_with_other_workers()
    outdir = tmp_path_factory.mktemp("ranks")
    procs = start_ranks("steps", outdir)
    try:
        with jax_pinned(), ThreadPoolExecutor(3) as ex:
            futures = {s: ex.submit(_jax_mesh_step, s) for s in "abc"}
            jax_steps = {s: f.result() for s, f in futures.items()}
        one_sp = port_step("sp")
        finish(procs)
    finally:
        for p in procs:
            p.kill()
    got = []
    for r in range(WORLD):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, jax_steps, one_sp


def test_pinned_mask_is_test_torch_training_s():
    from test_torch_training import pinned_mask as theirs

    for shape in ((2, 5, 5, 3), (4, 7)):
        assert np.array_equal(pinned_mask(shape, 0.9), theirs(shape, 0.9))


def test_helpers_split_and_gather_in_rank_order(ranks, monkeypatch):
    """mesh shape, local_batch_slice and shard_batch rows against the JAX
    package's (process count and index set to the rank's), fetch_global
    in rank order."""
    import jax

    from orca_tpu.parallel import multihost as jmh

    got, _, _ = ranks
    x = np.arange(8 * 3).reshape(8, 3)
    for r, out in enumerate(got):
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = jmh.local_batch_slice(8)
        assert out["slice"] == (want.start, want.stop)
        np.testing.assert_array_equal(out["shard"], x[want])
        np.testing.assert_array_equal(out["own"], x[:3] + 100 * r)
        np.testing.assert_array_equal(
            out["gathered"], np.repeat(np.arange(WORLD), 2)[:, None]
            * np.ones((1, 3)))
        assert out["mesh_shape"] == {"data": WORLD, "seq": 1}
        assert out["sp_mesh"] == ({"data": WORLD, "seq": 2}, ["cpu", "cpu"])


@pytest.mark.parametrize("stage", ["a", "b", "c"])
def test_two_rank_step_matches_jax_mesh_step(ranks, stage):
    """Float64, pinned draws: both ranks end the step with the JAX mesh
    step's params, momentum and metrics (the targets' halves hold different
    NaN counts)."""
    got, jax_steps, _ = ranks
    want_p, want_m, want_metrics = jax_steps[stage]
    for out in got:
        params, trace, metrics = out[stage]
        assert leaf_err(want_p, params) <= TOL
        assert leaf_err(want_m, trace) <= TOL
        assert set(metrics) == set(want_metrics)
        for k, v in want_metrics.items():
            assert abs(metrics[k] - v) <= TOL * max(1.0, abs(v)), k


def test_dp_sp_step_equals_one_process_step(ranks):
    """2 ranks x a row of the CPU named twice (the frozen tower sharded in
    two 448 kb shards), the port's own draws (dropout masks drawn at the
    global shape): the one-process step's params, momentum and metrics."""
    got, _, (want_p, want_m, want_metrics) = ranks
    for out in got:
        params, trace, metrics = out["sp"]
        assert leaf_err(want_p, params) <= TOL
        assert leaf_err(want_m, trace) <= TOL
        for k, v in want_metrics.items():
            assert abs(metrics[k] - v) <= TOL * max(1.0, abs(v)), k


def test_local_means_would_miss(ranks):
    """The case has teeth: with the ranks' own NaN counts as denominators,
    stage b's loss would differ from the global one by far more than TOL."""
    from orca_tpu_torch.training import losses

    d = inputs("b")
    t = torch.from_numpy(d["target"])
    valid = [torch.isfinite(losses.downsample_nanmean(t[i], B_GEOM[2], 32))
             .sum().item() for i in range(2)]
    assert valid[0] < 0.6 * valid[1]


if __name__ == "__main__":
    main(sys.argv[1:])
