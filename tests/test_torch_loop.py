"""The port's training loop (orca_tpu_torch.training.loop) and its input
pipeline (orca_tpu_torch.data.sampler, data.pipeline), on the CPU.

The sampler and the prefetch loader are copies of the JAX package's: the
same seed draws the same windows in both. The trainers run at the JAX
package's test geometries (stage a: 40 kb windows, crop 10; stage b:
CascadeGeometry(1_024_000, 4000, 8), levels (32, 1); stage c: a 2.048 Mb
cross-chromosome window at 32 kb bins, four levels) through train, validate,
the plateau scheduler, `ckpt_<step>.pt` checkpoints and restore; a killed
and resumed run replays the unkilled run's losses exactly (stage a with SWA,
stage b), the frozen tower running the fused kernels' plain versions.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from orca_tpu.data import sampler as jsampler
from orca_tpu.data import targets as jtargets
from orca_tpu.models.zoo import _random_normmats
from orca_tpu_torch.data import genome as tgenome
from orca_tpu_torch.data import pipeline as tpipe
from orca_tpu_torch.data import sampler as tsampler
from orca_tpu_torch.data import targets as ttargets
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.predict.multiscale import CascadeGeometry
from orca_tpu_torch.training import loop as tloop
from orca_tpu_torch.training.stages import (
    StageAConfig,
    StageBConfig,
    StageCConfig,
)
from orca_tpu_torch.utils.tree import tree_leaves
from test_torch_encoders import share_cpu_with_other_workers

share_cpu_with_other_workers()

B_GEOM = CascadeGeometry(1_024_000, 4000, 8)
C_GEOM = CascadeGeometry(2_048_000, 32_000, 2)


# --------------------------------------------------------------------------
# samplers and the prefetch loader
# --------------------------------------------------------------------------


def _chroms(rng, n, length):
    return {f"chr{i + 1}": rng.randint(0, 4, length).astype(np.uint8)
            for i in range(n)}


def _stage_a_sampler(pkg_genome, pkg_targets, pkg_sampler, seed=0):
    rng = np.random.RandomState(seed)
    gen = pkg_genome.CodeGenome(_chroms(rng, 2, 200_000))
    mats = {c: np.abs(rng.rand(200, 200)).astype(np.float32)
            for c, _ in gen.get_chr_lens()}
    target = pkg_targets.DenseContactMatrix(mats, resolution=1000,
                                            shape=(40, 40))
    return pkg_sampler.RandomWindowSampler(
        gen, target, sequence_length=40_000, position_resolution=1000,
        random_shift=100, random_strand=False, cross_chromosome=False,
        validation_holdout=["chr2"], test_holdout=[], seed=seed,
        packed_sequence=True,
    )


def _stage_c_sampler(pkg_genome, pkg_targets, pkg_sampler, seed=0):
    rng = np.random.RandomState(seed)
    chrlen = C_GEOM.window_bp // 2
    gen = pkg_genome.CodeGenome(_chroms(rng, 3, chrlen))
    nb = chrlen // C_GEOM.bin_bp
    mats = {c: np.abs(rng.rand(nb, nb)).astype(np.float32)
            for c, _ in gen.get_chr_lens()}
    target = pkg_targets.DenseContactMatrix(
        mats, resolution=C_GEOM.bin_bp, shape=(C_GEOM.bins, C_GEOM.bins))
    d = np.arange(C_GEOM.bins, dtype=np.float64)
    return pkg_sampler.RandomWindowSampler(
        gen, target, background_cis=np.exp(-1.2 * np.log1p(d) - 3.0),
        background_trans=float(np.exp(-9.0)),
        sequence_length=C_GEOM.window_bp, position_resolution=C_GEOM.bin_bp,
        random_strand=True, cross_chromosome=True, permute_segments=True,
        validation_holdout=["chr3"], test_holdout=[], seed=seed,
        packed_sequence=True,
    )


def _port_sampler(make, seed=0):
    return make(tgenome, ttargets, tsampler, seed)


def test_sampler_draws_equal_jax_package():
    """Same seed, same windows: the copy draws what the JAX package's
    sampler draws, in both modes, with strands, cross-chromosome mosaics and
    per-sample backgrounds."""
    from orca_tpu.data import genome as jgenome

    for make in (_stage_a_sampler, _stage_c_sampler):
        want = make(jgenome, jtargets, jsampler, 3)
        got = make(tgenome, ttargets, tsampler, 3)
        for mode in ("train", "validate", "train"):
            for w, g in zip(want.sample(2, mode=mode),
                            got.sample(2, mode=mode)):
                assert w.dtype == g.dtype
                np.testing.assert_array_equal(g, w)


class _SlowSampler:
    def __init__(self, delay=0.05):
        self.delay = delay
        self.rng = np.random.default_rng(0)

    def sample(self, batch_size, mode="train"):
        time.sleep(self.delay)
        return (self.rng.random((batch_size, 100, 4)).astype(np.float32),
                self.rng.random((batch_size, 10, 10)).astype(np.float32))


@pytest.mark.parametrize("backend", ["process", "thread"])
def test_prefetch_overlaps_and_reseeds(backend):
    delay, n = 0.05, 12
    with tpipe.PrefetchLoader(_SlowSampler(delay), batch_size=2,
                              num_workers=4, backend=backend) as loader:
        loader.get(timeout=10)
        t0 = time.time()
        batches = [loader.get(timeout=10) for _ in range(n)]
        dt = time.time() - t0
    assert [b[0].shape for b in batches] == [(2, 100, 4)] * n
    assert dt < n * delay * 0.75, dt
    firsts = {tuple(b[0].ravel()[:8]) for b in batches}
    assert len(firsts) > 1  # per-worker reseeding


class _RaisingSampler:
    def sample(self, batch_size, mode="train"):
        raise OSError("simulated cooler I/O failure")


def test_prefetch_worker_error_surfaces():
    with tpipe.PrefetchLoader(_RaisingSampler(), batch_size=1, num_workers=2,
                              backend="thread") as loader:
        with pytest.raises(tpipe.WorkerError, match="cooler I/O failure"):
            loader.get(timeout=10)
    with tpipe.PrefetchLoader(_SlowSampler(1.0), batch_size=1, num_workers=1,
                              backend="thread") as loader:
        with pytest.raises(TimeoutError):
            loader.get(timeout=0.2)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def test_checkpoint_files_round_trip(tmp_path):
    """ckpt_<step>.pt holds tensors, ints (the 64-bit step key included),
    floats and int-keyed dicts and loads with weights_only=True; the latest
    step wins; the sidecar holds the host state."""
    state = {"trainable": {"decoders": {32: [torch.arange(3.0)]}},
             "step": 7, "lr": 0.0018, "rng": 2 ** 64 - 5}
    tloop.save_state(str(tmp_path), 7, state)
    tloop.save_state(str(tmp_path), 12, dict(state, step=12))
    (tmp_path / "ckpt_99").mkdir()  # an orbax step dir is not read
    assert tloop.latest_checkpoint(str(tmp_path)).endswith("ckpt_12.pt")
    got = tloop.restore_state(str(tmp_path), "cpu")
    assert got["step"] == 12 and got["rng"] == 2 ** 64 - 5
    assert torch.equal(got["trainable"]["decoders"][32][0], torch.arange(3.0))
    tloop.save_host_state(str(tmp_path), 12, {"sched": {"lr": 1.0}})
    assert tloop.load_host_state(str(tmp_path), 12) == {"sched": {"lr": 1.0}}
    assert tloop.load_host_state(str(tmp_path), 7) is None
    assert tloop.restore_state(str(tmp_path / "none"), "cpu") is None
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_trainers_refuse_a_mesh_and_need_cuda_unless_told_cpu(tmp_path):
    """A mesh of one row in this process is taken (its first device holds
    the state and the batches, no data group); a mesh of several rows is
    refused, since a 'data' axis spans processes; without CUDA a trainer
    still needs device="cpu"."""
    from orca_tpu_torch.parallel.mesh import make_mesh

    loop = tloop.LoopConfig(workdir=str(tmp_path))
    cfg = StageAConfig(num_1d=None, crop=10, seq_len=40_000)
    sampler = _port_sampler(_stage_a_sampler)
    nm = np.full((10, 10), 0.1, np.float32)
    cpu = torch.device("cpu")
    tr = tloop.StageATrainer(cfg, loop, sampler, nm, 0.1, device="cpu",
                             mesh=make_mesh((1, 2), devices=[cpu] * 2))
    assert tr.device == cpu and tr.group is None
    assert torch.equal(tr._place(np.arange(6.0).reshape(2, 3)),
                       torch.arange(6.0).reshape(2, 3).double())
    with pytest.raises(ValueError, match="one row of its mesh"):
        tloop.StageATrainer(cfg, loop, sampler, nm, 0.1, device="cpu",
                            mesh=make_mesh((2, 1), devices=[cpu] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tloop.StageATrainer(cfg, loop, sampler, nm, 0.1)
        with pytest.raises(RuntimeError, match="CUDA"):
            tloop.StageBTrainer(StageBConfig(), loop, sampler, {}, {},
                                np.ones((1, 1, 1)), np.ones(1))


# --------------------------------------------------------------------------
# stage a
# --------------------------------------------------------------------------

A_CFG = StageAConfig(num_1d=None, crop=10, target_factor=4, seq_len=40_000,
                     remat=False)
A_NORMMAT = np.full((10, 10), 0.1, np.float32)


def _stage_a_trainer(workdir, checkpoint_every, use_swa=True,
                     validate_every=100):
    loop = tloop.LoopConfig(
        workdir=workdir, lr=0.002, batch_size=2,
        checkpoint_every=checkpoint_every, validate_every=validate_every,
        val_batches=1, use_swa=use_swa,
    )
    return tloop.StageATrainer(A_CFG, loop, _port_sampler(_stage_a_sampler),
                               A_NORMMAT, eps=0.1, device="cpu")


def _step_losses(trainer, upto):
    losses = []
    while trainer.step < upto:
        metrics = trainer.run(max_steps=trainer.step + 1)
        losses.append(float(metrics["loss"]))
    return losses


def test_stage_a_kill_and_resume_step_identical(tmp_path):
    """Killed after step 2 and resumed, a stage-a run with SWA replays the
    unkilled run's losses exactly: the step key, the SWA state, the plateau
    counters and the sampler's bit-generator state all persist."""
    ref = _stage_a_trainer(str(tmp_path / "ref"), checkpoint_every=100)
    ref_losses = _step_losses(ref, 4)

    killed = _stage_a_trainer(str(tmp_path / "kill"), checkpoint_every=2)
    assert _step_losses(killed, 2) == ref_losses[:2]
    killed.scheduler.step(0.5)
    killed.scheduler.step(0.4)
    killed.save()
    del killed

    resumed = _stage_a_trainer(str(tmp_path / "kill"), checkpoint_every=100)
    assert resumed.try_restore()
    assert resumed.step == 2 and resumed.swa_state["n"] == 2
    assert (resumed.scheduler.best, resumed.scheduler.num_bad) == (0.5, 1)
    assert _step_losses(resumed, 4) == ref_losses[2:]
    for a, b in zip(tree_leaves(ref.swa_state["avg"]),
                    tree_leaves(resumed.swa_state["avg"])):
        assert torch.equal(a, b)


def test_stage_a_trainer_validates_logs_and_checkpoints(tmp_path):
    tr = _stage_a_trainer(str(tmp_path), checkpoint_every=2,
                          validate_every=2, use_swa=False)
    metrics = tr.run(max_steps=2)
    assert tr.step == 2 and np.isfinite(float(metrics["loss"]))
    assert os.path.exists(tmp_path / "ckpt_2.pt")
    assert os.path.exists(tmp_path / "ckpt_2.host.json")
    rows = [json.loads(line) for line in
            open(tmp_path / "stage_a.metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 2]
    assert set(rows[0]) >= {"loss", "loss2d", "loss1d", "lr"}
    assert np.isfinite(rows[1]["val_pearson"])
    assert tr.scheduler.best == rows[1]["val_pearson"]


# --------------------------------------------------------------------------
# stage b
# --------------------------------------------------------------------------


def _stage_b_sampler(seed=0):
    rng = np.random.RandomState(seed)
    chrlen = 2 * B_GEOM.window_bp
    gen = tgenome.CodeGenome(_chroms(rng, 2, chrlen))
    nb = chrlen // B_GEOM.bin_bp
    mats = {c: np.abs(rng.rand(nb, nb)).astype(np.float32)
            for c, _ in gen.get_chr_lens()}
    mats["chr1"][::9] = np.nan  # some rows filtered out
    target = ttargets.DenseContactMatrix(
        mats, resolution=B_GEOM.bin_bp, shape=(B_GEOM.bins, B_GEOM.bins))
    return tsampler.RandomWindowSampler(
        gen, target, sequence_length=B_GEOM.window_bp,
        position_resolution=B_GEOM.bin_bp, random_strand=True,
        cross_chromosome=False, validation_holdout=["chr2"], test_holdout=[],
        seed=seed, packed_sequence=True,
    )


def _stage_b_trainer(workdir, checkpoint_every, validate_every=100,
                     accumulate=1):
    levels = (32, 1)
    gen = torch.Generator().manual_seed(0)
    trainable = {"pyramid": tenc.init_pyramid(gen, 5, True),
                 "decoders": {lv: tdec.init_decoder(gen) for lv in levels}}
    frozen = {
        "encoder": fold_params(tenc.init_encoder_tower(gen),
                               tenc.encoder_tower_spec()),
        "decoder_1pt": fold_params(tdec.init_decoder1m(gen),
                                   tdec.decoder1m_spec(1)),
    }
    nms, epss = _random_normmats(levels=levels, nbins=B_GEOM.bins,
                                 crop=B_GEOM.crop)
    loop = tloop.LoopConfig(
        workdir=workdir, lr=0.002, batch_size=1,
        checkpoint_every=checkpoint_every, validate_every=validate_every,
        val_batches=1,
    )
    cfg = StageBConfig(geometry=B_GEOM, encoder_block_bp=None, levels=levels)
    return tloop.StageBTrainer(
        cfg, loop, _stage_b_sampler(), trainable, frozen,
        np.stack([nms[lv] for lv in levels]).astype(np.float32),
        np.array([epss[lv] for lv in levels], np.float32),
        accumulate=accumulate, device="cpu")


def test_stage_b_kill_and_resume_step_identical(tmp_path):
    ref = _stage_b_trainer(str(tmp_path / "ref"), checkpoint_every=100)
    ref_losses = _step_losses(ref, 2)
    killed = _stage_b_trainer(str(tmp_path / "kill"), checkpoint_every=1)
    assert _step_losses(killed, 1) == ref_losses[:1]
    del killed
    resumed = _stage_b_trainer(str(tmp_path / "kill"), checkpoint_every=100)
    assert resumed.try_restore() and resumed.step == 1
    assert _step_losses(resumed, 2) == ref_losses[1:]
    for a, b in zip(tree_leaves(ref.trainable),
                    tree_leaves(resumed.trainable)):
        assert torch.equal(a, b)


def test_stage_b_trainer_validate_lr_drop_save_restore(tmp_path):
    """Train -> validate -> LR drop -> save -> restore; the frozen params
    stay bit-equal, the trainable ones move."""
    tr = _stage_b_trainer(str(tmp_path), checkpoint_every=2,
                          accumulate=2)
    before = [t.clone() for t in tree_leaves(tr.trainable)]
    frozen = [t.clone() for t in tree_leaves(tr.frozen)]
    tr.run(max_steps=2)
    assert tr.step == 2
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(tr.trainable)))
    assert all(torch.equal(a, b)
               for a, b in zip(frozen, tree_leaves(tr.frozen)))
    tr.scheduler.patience = 0
    corr = tr.validate()
    assert np.isfinite(corr)
    rows = [json.loads(line) for line in
            open(tmp_path / "stage_b.metrics.jsonl")]
    assert set(rows[-1]) >= {"val_pearson", "val_mse_32", "val_pearson_1"}
    tr.scheduler.step(corr)
    tr.scheduler.step(corr - 1.0)
    assert tr.scheduler.lr < 0.002
    tr.save()
    tr2 = _stage_b_trainer(str(tmp_path), checkpoint_every=2, accumulate=2)
    assert tr2.try_restore() and tr2.step == 2
    assert tr2.scheduler.lr == tr.scheduler.lr
    for a, b in zip(tree_leaves(tr.trainable), tree_leaves(tr2.trainable)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tr.opt_state), tree_leaves(tr2.opt_state)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# stage c
# --------------------------------------------------------------------------


def test_stage_c_trainer_runs_validates_and_restores(tmp_path):
    """Cross-chromosome windows with per-sample backgrounds (packed uint8
    sequences end to end) through a stage-c trainer and a thread-backed
    prefetch loader; restore into a fresh trainer."""
    gen = torch.Generator().manual_seed(1)
    levels = (256, 128, 64, 32)

    def trainer(num_workers):
        g = torch.Generator().manual_seed(2)
        trainable = {"pyramid": tenc.init_pyramid(g, 3, True),
                     "decoders": {lv: tdec.init_decoder(g) for lv in levels}}
        loop = tloop.LoopConfig(
            workdir=str(tmp_path), lr=0.002, batch_size=1,
            checkpoint_every=2, validate_every=2, val_batches=1,
            num_workers=num_workers, loader_backend="thread",
        )
        return tloop.StageCTrainer(
            StageCConfig(geometry=C_GEOM, levels=levels,
                         encoder_block_bp=None),
            loop, _port_sampler(_stage_c_sampler), trainable, frozen,
            nan_skip=1.1, accumulate=1, device="cpu")

    frozen = {
        "encoder": fold_params(tenc.init_encoder_tower(gen),
                               tenc.encoder_tower_spec()),
        "pyramid1": fold_params(tenc.init_pyramid(gen, 5, True),
                                tenc.pyramid_spec(5, True)),
    }
    tr = trainer(num_workers=2)
    metrics = tr.run(max_steps=2)
    assert tr.step == 2 and tr._loader is None
    assert set(metrics) == {"loss"} | {f"loss_{lv}" for lv in levels}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    rows = [json.loads(line) for line in
            open(tmp_path / "stage_c.metrics.jsonl")]
    assert np.isfinite(rows[-1]["val_pearson"])
    tr2 = trainer(num_workers=0)
    assert tr2.try_restore() and tr2.step == 2
    for a, b in zip(tree_leaves(tr.trainable), tree_leaves(tr2.trainable)):
        assert torch.equal(a, b)
