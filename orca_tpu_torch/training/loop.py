"""Training loop drivers for the three stages (counterpart of
orca_tpu/training/loop.py). Each stage's Trainer has:

  * a sampler-backed input pipeline (data.sampler, data.pipeline);
  * the stage step (training.stages) on one device, or data-parallel over
    the processes of a mesh (parallel.multihost), whose row of devices may
    also shard the frozen tower's sequence;
  * checkpoints with the full state (params, optimizer, SWA, step, learning
    rate, step key) as `ckpt_<step>.pt` (`torch.save`, loadable with
    weights_only=True), beside a JSON sidecar for the host state (plateau
    counters, the sampler's bit-generator state);
  * validation with per-window Pearson r driving ReduceLROnPlateau;
  * SWA (stage a), and JSONL metrics.

The random state of the steps is one key (utils.rng), saved in the
checkpoint, so a killed-and-resumed run with synchronous sampling replays
the losses of an unkilled one. The JAX package's orbax checkpoints are not
read.

Over a mesh whose 'data' axis spans N processes, every process samples the
same global batch and keeps its rows (multihost.shard_batch); the state
starts as rank 0's and stays bit-identical on every rank, which `save`
checks before rank 0 writes the checkpoint; each rank writes its own host
sidecar (`.p<rank>`), and only rank 0 logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterator, Optional

import numpy as np
import torch

from orca_tpu_torch.nn import decoders
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.parallel import multihost
from orca_tpu_torch.training import optim
from orca_tpu_torch.training import swa as swa_lib
from orca_tpu_torch.training.stages import (
    StageAConfig,
    StageBConfig,
    StageCConfig,
    make_stage_a_step,
    make_stage_b_eval,
    make_stage_b_step,
    make_stage_c_eval,
    make_stage_c_step,
    stage_a_eval_metrics,
)
from orca_tpu_torch.utils import rng as rng_lib
from orca_tpu_torch.utils.config import resolve_device
from orca_tpu_torch.utils.logging import MetricsLogger

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


@dataclasses.dataclass
class LoopConfig:
    workdir: str
    lr: float = 0.002
    batch_size: int = 16
    checkpoint_every: int = 500
    validate_every: int = 2000
    val_batches: int = 8
    max_steps: Optional[int] = None
    use_swa: bool = False
    seed: int = 314
    # parallel input pipeline (the reference SamplerDataLoader's workers);
    # 0 = sample synchronously in the step loop
    num_workers: int = 0
    loader_backend: str = "process"


def save_state(workdir: str, step: int, state: dict) -> None:
    """Write `state` (tensors, ints, floats, dicts, lists) as
    <workdir>/ckpt_<step>.pt, atomically."""
    path = os.path.join(os.path.abspath(workdir), f"ckpt_{step}.pt")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def latest_checkpoint(workdir: str) -> Optional[str]:
    if not os.path.isdir(workdir):
        return None
    steps = [int(m.group(1)) for m in map(_CKPT.match, os.listdir(workdir))
             if m]
    if not steps:
        return None
    return os.path.join(os.path.abspath(workdir), f"ckpt_{max(steps)}.pt")


def restore_state(workdir: str, *, device=None) -> Optional[dict]:
    """The latest checkpoint in workdir, its tensors on `device`, or None."""
    path = latest_checkpoint(workdir)
    if path is None:
        return None
    return torch.load(path, map_location=device, weights_only=True)


def _host_state_path(workdir: str, step: int) -> str:
    # one file per process on multi-process runs, so no two processes write
    # one file; under global-batch semantics the sampler state is the same
    # on every process, so any one sidecar restores the run
    suffix = ("" if multihost.process_count() == 1
              else f".p{multihost.process_index()}")
    return os.path.join(os.path.abspath(workdir),
                        f"ckpt_{step}.host{suffix}.json")


def save_host_state(workdir: str, step: int, payload: dict) -> None:
    """JSON sidecar of the checkpoint for host state that is not tensors:
    plateau-scheduler counters and the sampler's bit-generator state
    (arbitrary-precision ints). Written atomically."""
    path = _host_state_path(workdir, step)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def load_host_state(workdir: str, step: int) -> Optional[dict]:
    path = _host_state_path(workdir, step)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _sampler_rng_state(sampler) -> Optional[dict]:
    bg = getattr(getattr(sampler, "rng", None), "bit_generator", None)
    return bg.state if bg is not None else None


def _restore_sampler_rng(sampler, state: Optional[dict]) -> None:
    if state is None:
        return
    bg = getattr(getattr(sampler, "rng", None), "bit_generator", None)
    if bg is not None and state.get("bit_generator") == type(bg).__name__:
        bg.state = state


def _mesh_encoder_fn(mesh, block_bp):
    """The frozen tower's call for a mesh whose 'seq' axis has more than one
    device: this process's rows, sequence-sharded over its row of devices
    (parallel.sequence). None (the one-device tower) otherwise."""
    if mesh is None or mesh.shape.get("seq", 1) <= 1:
        return None
    from orca_tpu_torch.parallel.sequence import sharded_encoder_tower

    row = mesh.local()

    def encoder_fn(p, s):
        return sharded_encoder_tower(p, s, row, block_bp=block_bp)

    return encoder_fn


class _Trainer:
    """What every stage's trainer shares: the device and the mesh, batch
    placement, state replication, checkpoint writing and the host state."""

    def _setup_mesh(self, mesh, device):
        """self.mesh, self.group (its data group, None for one process) and
        self.device: the first device of the mesh's row, which holds the
        state and the batches, else `device` (None = CUDA)."""
        device = resolve_device(device)
        self.mesh = mesh
        self.group = mesh.data_group if mesh is not None else None
        if mesh is None:
            self.device = device
            return
        if len(mesh.devices) != 1:
            raise ValueError(
                f"a trainer drives one row of its mesh, not {mesh.shape}: "
                "a 'data' axis of N spans N processes (training.launch "
                "starts them)")
        self.device = mesh.device()
        if self.device.type != device.type:
            raise ValueError(f"the mesh is on {self.device}, the trainer "
                             f"was asked for {device}")

    def _place(self, *arrays):
        if self.mesh is not None:
            return multihost.shard_batch(self.mesh, *arrays)
        out = tuple(torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
                    for a in arrays)
        return out if len(out) > 1 else out[0]

    def _replicate(self, tree):
        """Rank 0's tree on every rank (unchanged without a group)."""
        if self.group is None:
            return tree
        return self.group.broadcast_tree(tree)

    def _state(self) -> dict:
        raise NotImplementedError

    def save(self):
        """Rank 0 writes the checkpoint, after checking that every rank
        holds the same state; every rank writes its host sidecar."""
        state = self._state()
        if self.group is not None:
            self.group.check_replicas(state, f"the states at step {self.step}")
        if multihost.is_primary():
            save_state(self.loop.workdir, self.step, state)
        save_host_state(self.loop.workdir, self.step, {
            "sched": self.scheduler.state_dict(),
            "sampler_rng": _sampler_rng_state(self.sampler),
        })
        if self.group is not None:
            self.group.barrier()

    def _restore(self) -> Optional[dict]:
        """Load the latest checkpoint's common state (step, learning rate,
        step key, host sidecar); returns the checkpoint or None."""
        restored = restore_state(self.loop.workdir, device=self.device)
        if restored is None:
            return None
        self.step = int(restored["step"])
        self.scheduler.lr = float(restored["lr"])
        self.rng = int(restored["rng"])
        host = load_host_state(self.loop.workdir, self.step)
        if host:
            self.scheduler.load_state_dict(host["sched"])
            _restore_sampler_rng(self.sampler, host.get("sampler_rng"))
        return restored


class StageATrainer(_Trainer):
    """1 Mb model training (the reference's train_h1esc_a.py)."""

    def __init__(self, cfg: StageAConfig, loop: LoopConfig, sampler,
                 normmat_r: np.ndarray, eps: float,
                 params: Optional[dict] = None, mesh=None, *, device=None):
        """device: None = CUDA. mesh: None for one device, else a mesh of
        one row of devices in this process (parallel.mesh.make_mesh, or
        multihost.make_multihost_mesh when its 'data' axis spans
        processes): batches are placed data-parallel, the state starts as
        rank 0's."""
        self._setup_mesh(mesh, device)
        self.cfg = cfg
        self.loop = loop
        self.sampler = sampler
        self.normmat_r = torch.as_tensor(normmat_r, dtype=torch.float32,
                                         device=self.device)
        self.eps = float(eps)
        self.opt, self.step_fn = make_stage_a_step(cfg, device=self.device,
                                                   group=self.group)
        gen = torch.Generator(device=self.device).manual_seed(loop.seed)
        self.params = self._replicate(params or decoders.init_net(
            gen, num_1d=cfg.num_1d, num_2d=getattr(cfg, "num_2d", 1)))
        self.opt_state = self.opt.init(self.params)
        self.swa_state = (swa_lib.swa_init(self.params) if loop.use_swa
                          else None)
        self.bn_refresh = (swa_lib.make_swa_bn_refresh(cfg, group=self.group)
                           if loop.use_swa else None)
        self.scheduler = optim.ReduceLROnPlateau(lr=loop.lr)
        self.step = 0
        self.logger = MetricsLogger(loop.workdir, "stage_a")
        self.rng = rng_lib.key(loop.seed + 1)

    def _state(self):
        s = {"params": self.params, "opt_state": self.opt_state,
             "step": self.step, "lr": self.scheduler.lr, "rng": self.rng}
        if self.swa_state is not None:
            s["swa"] = self.swa_state
        return s

    def try_restore(self) -> bool:
        """Step-identical resume: params, optimizer, step, the step key, the
        plateau counters and the sampler's bit-generator state (synchronous
        sampling; prefetch workers' draw order is not replayed)."""
        restored = self._restore()
        if restored is None:
            return False
        self.params = restored["params"]
        self.opt_state = restored["opt_state"]
        if self.swa_state is not None and "swa" in restored:
            self.swa_state = restored["swa"]
        return True

    def train_batches(self) -> Iterator[tuple]:
        if self.loop.num_workers > 0:
            from orca_tpu_torch.data.pipeline import PrefetchLoader

            with PrefetchLoader(
                self.sampler, self.loop.batch_size, mode="train",
                num_workers=self.loop.num_workers,
                backend=self.loop.loader_backend, seed=self.loop.seed,
            ) as loader:
                yield from loader
        else:
            while True:
                yield self.sampler.sample(self.loop.batch_size, mode="train")

    def _target_1d(self, batch):
        seq = batch[0]
        return batch[-1] if self.cfg.num_1d else np.zeros(
            (seq.shape[0], self.cfg.crop, 0), np.float32)

    def run(self, max_steps: Optional[int] = None):
        max_steps = max_steps or self.loop.max_steps
        for batch in self.train_batches():
            seq_d, target_d, target_1d_d = self._place(
                batch[0], batch[1], self._target_1d(batch))
            self.rng, sub = rng_lib.split(self.rng, 2)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, seq_d, target_d, target_1d_d,
                sub, self.scheduler.lr, self.normmat_r, self.eps,
            )
            if self.swa_state is not None:
                self.swa_state = swa_lib.swa_update(self.swa_state,
                                                    self.params)
                # BN-statistics refresh: a train-mode forward of the
                # averaged params on this batch
                self.rng, sub_bn = rng_lib.split(self.rng, 2)
                self.swa_state = self.bn_refresh(self.swa_state, seq_d,
                                                 sub_bn)
            self.step += 1
            if self.step % self.loop.checkpoint_every == 0:
                self.logger.log(self.step, lr=self.scheduler.lr, **metrics)
                self.save()
            if self.step % self.loop.validate_every == 0:
                corr = self.validate()
                self.scheduler.step(corr)
                self.logger.log(self.step, val_pearson=corr,
                                lr=self.scheduler.lr)
            if max_steps is not None and self.step >= max_steps:
                return metrics

    def validate(self) -> float:
        """Mean per-window Pearson r over `val_batches` holdout batches, on
        a folded copy of the (SWA-averaged) params: on the card the tower
        runs the fused kernels."""
        params = (self.swa_state["avg"] if self.swa_state is not None
                  else self.params)
        folded = fold_params(params, decoders.net_spec(self.cfg.num_1d,
                                                       self.cfg.num_2d))
        corrs = []
        for _ in range(self.loop.val_batches):
            batch = self.sampler.sample(self.loop.batch_size, mode="validate")
            seq_d, target_d, target_1d_d = self._place(
                batch[0], batch[1], self._target_1d(batch))
            corr, _mse, _bce = stage_a_eval_metrics(
                folded, self.cfg, seq_d, target_d, target_1d_d,
                self.normmat_r, self.eps, group=self.group)
            corrs.append(multihost.fetch_global(corr, mesh=self.mesh))
        return float(np.nanmean(np.concatenate(corrs)))


class StageBTrainer(_Trainer):
    """1-32 Mb stage training (the reference's train_h1esc_b.py):
    accumulates windows, skips >50%-NaN targets, random zoom cascade."""

    def __init__(self, cfg: StageBConfig, loop: LoopConfig, sampler,
                 trainable: dict, frozen: dict, normmats: np.ndarray,
                 epss: np.ndarray, nan_skip: float = 0.5,
                 accumulate: int = 4, mesh=None, *, device=None):
        """device, mesh: as for StageATrainer; a mesh whose 'seq' axis has
        more than one device also shards the frozen tower's sequence over
        its row (the reference trains every stage on 4 GPUs,
        train_h1esc_b.py:170-187)."""
        self._setup_mesh(mesh, device)
        self.normmats = torch.as_tensor(normmats, dtype=torch.float32,
                                        device=self.device)
        self.epss = torch.as_tensor(epss, dtype=torch.float32,
                                    device=self.device)
        encoder_fn = _mesh_encoder_fn(mesh, cfg.encoder_block_bp)
        opt, step_fn = make_stage_b_step(cfg, encoder_fn, device=self.device,
                                         group=self.group)
        eval_fn = make_stage_b_eval(cfg, encoder_fn, device=self.device,
                                    group=self.group)
        self._base_init(cfg, loop, sampler, trainable, frozen, nan_skip,
                        accumulate, opt, step_fn, eval_fn, "stage_b")

    def _base_init(self, cfg, loop, sampler, trainable, frozen, nan_skip,
                   accumulate, opt, step_fn, eval_fn, stage_name):
        """State shared by the cascade-stage trainers (B and C)."""
        self.cfg = cfg
        self.loop = loop
        self.sampler = sampler
        self.trainable = self._replicate(trainable)
        self.frozen = self._replicate(frozen)
        self.nan_skip = nan_skip
        self.accumulate = accumulate
        self.opt, self.step_fn, self.eval_fn = opt, step_fn, eval_fn
        self.opt_state = self.opt.init(trainable)
        self.scheduler = optim.ReduceLROnPlateau(lr=loop.lr)
        self.step = 0
        self.logger = MetricsLogger(loop.workdir, stage_name)
        self.rng = rng_lib.key(loop.seed)
        self._loader = None

    def _sample(self, mode: str):
        """One sampler draw; training draws come from the prefetch workers
        when num_workers > 0."""
        if mode == "train" and self.loop.num_workers > 0:
            if self._loader is None:
                from orca_tpu_torch.data.pipeline import PrefetchLoader

                self._loader = PrefetchLoader(
                    self.sampler, 1, mode="train",
                    num_workers=self.loop.num_workers,
                    backend=self.loop.loader_backend, seed=self.loop.seed,
                )
            return self._loader.get()
        return self.sampler.sample(1, mode=mode)

    def close(self):
        if self._loader is not None:
            self._loader.close()
            self._loader = None

    def _accumulate_batch(self, mode: str = "train"):
        seqs, targets = [], []
        while len(seqs) < self.accumulate:
            seq, target = self._sample(mode)[:2]
            if np.isnan(target).mean() > self.nan_skip:
                continue
            seqs.append(seq[0])
            targets.append(target[0])
        return np.stack(seqs), np.stack(targets)

    def _state(self):
        return {"trainable": self.trainable, "opt_state": self.opt_state,
                "step": self.step, "lr": self.scheduler.lr, "rng": self.rng}

    def try_restore(self) -> bool:
        """Step-identical resume from the latest checkpoint in workdir:
        see StageATrainer.try_restore."""
        restored = self._restore()
        if restored is None:
            return False
        self.trainable = restored["trainable"]
        self.opt_state = restored["opt_state"]
        return True

    def _eval_batch(self):
        seq, target = self._accumulate_batch(mode="validate")
        seq_d, target_d = self._place(seq, target)
        return self.eval_fn(self.trainable, self.frozen, seq_d, target_d,
                            self.normmats, self.epss)

    def validate(self) -> float:
        """Fixed-offset validation cascade: per-level masked MSE and
        per-sample Pearson r on holdout windows. Returns the mean over
        levels of the Pearson r (the plateau metric)."""
        level_corrs = {lv: [] for lv in self.cfg.levels}
        level_mses = {lv: [] for lv in self.cfg.levels}
        for _ in range(self.loop.val_batches):
            mses, corrs = self._eval_batch()
            for lv in self.cfg.levels:
                level_corrs[lv].append(
                    multihost.fetch_global(corrs[lv], mesh=self.mesh))
                level_mses[lv].append(float(mses[lv]))
        metrics = {}
        for lv in self.cfg.levels:
            metrics[f"val_pearson_{lv}"] = float(
                np.nanmean(np.concatenate(level_corrs[lv])))
            metrics[f"val_mse_{lv}"] = float(np.mean(level_mses[lv]))
        corr = float(np.nanmean(
            [metrics[f"val_pearson_{lv}"] for lv in self.cfg.levels]))
        self.logger.log(self.step, val_pearson=corr, **metrics)
        return corr

    def run(self, max_steps: Optional[int] = None):
        try:
            return self._run(max_steps)
        finally:
            self.close()

    def _train_step(self, sub):
        seq, target = self._accumulate_batch()
        seq_d, target_d = self._place(seq, target)
        self.trainable, self.opt_state, metrics = self.step_fn(
            self.trainable, self.frozen, self.opt_state, seq_d, target_d,
            sub, self.scheduler.lr, self.normmats, self.epss,
        )
        return metrics

    def _run(self, max_steps: Optional[int] = None):
        max_steps = max_steps or self.loop.max_steps
        metrics = {}
        while max_steps is None or self.step < max_steps:
            self.rng, sub = rng_lib.split(self.rng, 2)
            metrics = self._train_step(sub)
            self.step += 1
            if self.step % self.loop.checkpoint_every == 0:
                self.logger.log(self.step, lr=self.scheduler.lr, **metrics)
                self.save()
            if self.step % self.loop.validate_every == 0:
                corr = self.validate()
                self.scheduler.step(corr)
        return metrics


class StageCTrainer(StageBTrainer):
    """32-256 Mb stage training (the reference's train_h1esc_c.py):
    cross-chromosome samples with per-sample background normmats."""

    def __init__(self, cfg: StageCConfig, loop: LoopConfig, sampler,
                 trainable: dict, frozen: dict, nan_skip: float = 0.5,
                 accumulate: int = 1, mesh=None, *, device=None):
        """device, mesh: as for StageBTrainer (the 256 Mb windows are where
        sharding the tower's sequence matters most)."""
        self._setup_mesh(mesh, device)
        encoder_fn = _mesh_encoder_fn(mesh, cfg.encoder_block_bp)
        opt, step_fn = make_stage_c_step(cfg, encoder_fn, device=self.device,
                                         group=self.group)
        eval_fn = make_stage_c_eval(cfg, encoder_fn, device=self.device,
                                    group=self.group)
        self._base_init(cfg, loop, sampler, trainable, frozen, nan_skip,
                        accumulate, opt, step_fn, eval_fn, "stage_c")

    def _accumulate_batch(self, mode: str = "train"):
        seqs, targets, normmats = [], [], []
        while len(seqs) < self.accumulate:
            seq, target, normmat = self._sample(mode)[:3]
            if np.isnan(target).mean() > self.nan_skip:
                continue
            nm = normmat[0]
            mask = np.isnan(nm)
            if mask.any():
                nm = np.where(mask, np.nanmin(nm), nm)
            seqs.append(seq[0])
            targets.append(target[0])
            normmats.append(nm)
        return np.stack(seqs), np.stack(targets), np.stack(normmats)

    def _eval_batch(self):
        seq, target, normmat = self._accumulate_batch(mode="validate")
        seq_d, target_d, normmat_d = self._place(seq, target, normmat)
        return self.eval_fn(self.trainable, self.frozen, seq_d, target_d,
                            normmat_d)

    def _train_step(self, sub):
        seq, target, normmat = self._accumulate_batch()
        seq_d, target_d, normmat_d = self._place(seq, target, normmat)
        self.trainable, self.opt_state, metrics = self.step_fn(
            self.trainable, self.frozen, self.opt_state, seq_d, target_d,
            normmat_d, sub, self.scheduler.lr,
        )
        return metrics
