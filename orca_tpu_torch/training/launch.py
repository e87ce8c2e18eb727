"""Operator-facing training launch layer (counterpart of
orca_tpu/training/launch.py).

One config-driven entry point assembles each stage's data path into its
trainer, in place of the reference's eight training scripts:

    python -m orca_tpu_torch.cli train a --config job.json [--max-steps N]

`TrainJob` is the single source of truth: a JSON file with the JAX
package's fields (command-line flags override). Every stage supports
scaled-down windows (window_bp), so the whole launch path runs in tests.
Jobs run on the CUDA card (`run(job)`), or where `run(job, device=...)`
says. Stages b and c start from a stage-a (and stage-b) run of this package
(`ckpt_<step>.pt` in its workdir) or from the reference's released
statedicts; the JAX package's orbax workdirs are not read.

Across devices (`mesh`, e.g. "data=2,seq=2"): the 'data' axis is one
process per index, each driving 'seq' devices. `run` starts the N
processes of a one-process job itself, as torchrun would (devices
cuda:[r·seq, (r+1)·seq) for process r, a localhost rendezvous); a job with
`multihost: true` is one process of a run started by torchrun. Batch counts
(batch_size, accumulate) stay global and must divide over the processes.

| stage | window | target res | pos res | shift | strand | cross-chrom |
|-------|--------|-----------|---------|-------|--------|-------------|
| a     | 1Mb    | 1000      | 1000    | 100   | no     | no          |
| b     | 32Mb   | 4000      | 4000    | 1000  | yes    | no          |
| c     | 256Mb  | 32000     | 32000   | 4000  | yes    | yes+permute |
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from orca_tpu_torch.utils.config import resolve_device


# --------------------------------------------------------------------------
# Job config
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TrainJob:
    """One training run: stage + data paths + hyperparameters."""

    stage: str  # "a" | "b" | "c"
    workdir: str
    cell: str = "h1esc"

    # -- genome ----------------------------------------------------------
    genome_memmap: Optional[str] = None  # from `orca-tpu build-genome`
    genome_fasta: Optional[str] = None  # small genomes: parse directly

    # -- 2D target -------------------------------------------------------
    # production: 'path.rebinned.mcool::/resolutions/<res>' (cooler).
    # A LIST of sources trains a multi-cell-type model (leukemia-style):
    # one output head per dataset, stacked via StackedContactMatrix.
    cooler_uri: Optional[Tuple[str, ...]] = None  # str also accepted
    # tests/small organisms: .npz of per-chromosome dense balanced matrices
    dense_store: Optional[Tuple[str, ...]] = None  # str also accepted
    adaptive_cg: bool = True  # adaptive coarse-graining (cg=True, ref)

    # -- 1D chromatin tracks (stage a only) ------------------------------
    bed_path: Optional[str] = None  # BED(.gz) of (chrom, start, end, name)
    bed_features: Optional[str] = None  # file: one feature name per line

    # -- distance backgrounds --------------------------------------------
    # one per 2D-target source (multi-head jobs list several)
    expectation_npy: Optional[Tuple[str, ...]] = None  # a: res1000; b: res4000
    background_cis_npy: Optional[str] = None  # stage c: res32000.mono
    background_trans_npy: Optional[str] = None  # stage c: res32000.trans

    # -- sampling --------------------------------------------------------
    validation_holdout: Tuple[str, ...] = ("chr8",)
    test_holdout: Tuple[str, ...] = ("chr9", "chr10")
    seed: int = 314

    # -- initialization for stages b/c -----------------------------------
    # EITHER a prior-stage workdir of this package (ckpt_<step>.pt) ...
    init_workdir_a: Optional[str] = None  # stage-a run (b and c need it)
    init_workdir_b: Optional[str] = None  # stage-b run (c needs it)
    # ... OR a reference statedict dir (torch checkpoints via convert)
    init_statedict_dir: Optional[str] = None

    # -- loop ------------------------------------------------------------
    lr: float = 0.002
    batch_size: int = 16  # stage a (ref: 16); stages b/c use accumulate
    accumulate: int = 4  # stage b window buffer (train_h1esc_b.py:170)
    num_workers: int = 0
    loader_backend: str = "process"
    use_swa: bool = False
    max_steps: Optional[int] = None
    checkpoint_every: int = 500
    validate_every: int = 2000
    val_batches: int = 8
    resume: bool = True

    # -- scale / parallelism ---------------------------------------------
    window_bp: Optional[int] = None  # default per stage (1/32/256 Mb)
    target_resolution: Optional[int] = None  # default per stage
    # cascade level subset for scaled test runs (stage b: any subset of
    # (32,16,8,4,2,1); stage c: a prefix of (256,128,64,32))
    levels: Optional[Tuple[int, ...]] = None
    mesh: str = ""  # e.g. "data=4,seq=2"; "" = single device
    # one process of a multi-process run started by torchrun (its
    # environment names the rendezvous); the mesh spec's seq=M is then the
    # devices per process, and 'data' spans the processes. Samplers stay
    # identically seeded on every process: each draws the same GLOBAL batch
    # and multihost.shard_batch keeps only its rows, so an N-process run
    # computes the single-process run's steps
    multihost: bool = False
    packed_sequence: bool = True  # uint8 wire format through the loader
    # stage-b Encoder2 upward pass; False for leukemia-style models
    # (orca_leukemia.py:1499-1601) and HCTnoc (Encoder2b)
    pyramid_up_pass: bool = True

    @classmethod
    def from_json(cls, path: str, **overrides) -> "TrainJob":
        with open(path) as f:
            data = json.load(f)
        data.update({k: v for k, v in overrides.items() if v is not None})
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown TrainJob fields in {path}: {unknown}")
        for key in ("validation_holdout", "test_holdout", "levels"):
            if data.get(key) is not None:
                data[key] = tuple(data[key])
        return cls(**data)


_STAGE_DEFAULTS = {
    # window_bp, target resolution, random_shift, random_strand
    "a": (1_000_000, 1000, 100, False),
    "b": (32_000_000, 4000, 1000, True),
    "c": (256_000_000, 32000, 4000, True),
}


def _stage_geometry(job: TrainJob):
    window_bp, res, shift, strand = _STAGE_DEFAULTS[job.stage]
    window_bp = job.window_bp or window_bp
    res = job.target_resolution or res
    return window_bp, res, shift, strand


# --------------------------------------------------------------------------
# Data assembly
# --------------------------------------------------------------------------


def build_genome(job: TrainJob):
    from orca_tpu_torch.data.genome import FastaGenome, MemmapGenome

    if job.genome_memmap:
        return MemmapGenome(job.genome_memmap)
    if job.genome_fasta:
        return FastaGenome(job.genome_fasta)
    raise ValueError("TrainJob needs genome_memmap or genome_fasta")


def _as_tuple(v):
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def build_target(job: TrainJob, res: int, bins: int):
    from orca_tpu_torch.data.targets import (
        CoolerContactMatrix,
        DenseContactMatrix,
        StackedContactMatrix,
    )

    sources = []
    for uri in _as_tuple(job.cooler_uri):
        sources.append(CoolerContactMatrix(
            uri, shape=(bins, bins), cg=job.adaptive_cg
        ))
    for store in _as_tuple(job.dense_store):
        with np.load(store) as z:
            mats = {c: z[c].astype(np.float32) for c in z.files}
        sources.append(DenseContactMatrix(
            mats, resolution=res, shape=(bins, bins)
        ))
    if not sources:
        raise ValueError("TrainJob needs cooler_uri or dense_store")
    if len(sources) == 1:
        return sources[0]
    # multi-cell-type job: one head per dataset (leukemia-style)
    return StackedContactMatrix(sources)


def build_target_1d(job: TrainJob, crop: int):
    """Stage-a 1D chromatin-track target (ref MultibinGenomicFeatures with
    bin 4000, mode 'any', shape (num_tracks, 250);
    train_h1esc_a.py:55-62)."""
    if not job.bed_path:
        return None
    if not job.bed_features:
        raise ValueError(
            "bed_path is set but bed_features (file listing one track name "
            "per line) is missing"
        )
    from orca_tpu_torch.data.targets import BinnedBedFeatures

    with open(job.bed_features) as f:
        features = [ln.strip() for ln in f if ln.strip()]
    return BinnedBedFeatures(
        job.bed_path, features, bin_size=4000, step_size=4000,
        shape=(len(features), crop), mode="any",
    )


def build_sampler(job: TrainJob):
    from orca_tpu_torch.data.sampler import RandomWindowSampler

    window_bp, res, shift, strand = _stage_geometry(job)
    bins = window_bp // res
    genome = build_genome(job)
    target = build_target(job, res, bins)
    kw = dict(
        genome=genome,
        target=target,
        seed=job.seed,
        validation_holdout=job.validation_holdout,
        test_holdout=job.test_holdout,
        sequence_length=window_bp,
        position_resolution=res,
        random_shift=shift,
        random_strand=strand,
        cross_chromosome=(job.stage == "c"),
        permute_segments=(job.stage == "c"),
        packed_sequence=job.packed_sequence,
    )
    if job.stage == "a":
        kw["target_1d"] = build_target_1d(job, window_bp // 4000)
    if job.stage == "c":
        if not (job.background_cis_npy and job.background_trans_npy):
            raise ValueError(
                "stage c needs background_cis_npy and background_trans_npy "
                "(res32000 .mono/.trans expectations)"
            )
        kw["background_cis"] = np.exp(np.load(job.background_cis_npy))
        kw["background_trans"] = float(np.exp(np.load(job.background_trans_npy)))
    return RandomWindowSampler(**kw)


def mesh_sizes(job: TrainJob) -> dict:
    """The job's mesh spec as {"data": N, "seq": M} (absent axes 1); a
    typo'd axis raises rather than shrinking the mesh."""
    sizes = dict(part.split("=")
                 for part in job.mesh.replace(" ", "").split(",") if part)
    unknown = set(sizes) - {"data", "seq"}
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)} in {job.mesh!r} "
            "(expected 'data=N,seq=M')"
        )
    return {axis: int(sizes.get(axis, 1)) for axis in ("data", "seq")}


def build_mesh(job: TrainJob, *, device=None):
    """None for one device. With `multihost`, join the process group
    (torchrun's environment; gloo on the CPU, nccl on CUDA) and return this
    process's row of a mesh whose 'data' axis is the processes. Otherwise a
    one-process (1, seq) mesh over the local devices (the CPU named seq
    times); a 'data' axis of N > 1 needs N processes, which `run` starts."""
    sizes = mesh_sizes(job)
    if not job.mesh and not job.multihost:
        return None
    device = resolve_device(device)
    from orca_tpu_torch.parallel import mesh as mesh_lib
    from orca_tpu_torch.parallel import multihost

    if job.multihost:
        multihost.initialize(backend="gloo" if device.type == "cpu" else None)
        world = multihost.process_count()
        if "data=" in job.mesh.replace(" ", "") and sizes["data"] != world:
            raise ValueError(f"the mesh {job.mesh!r} names data="
                             f"{sizes['data']}, the run has {world} processes")
        return multihost.make_multihost_mesh(sizes["seq"],
                                             device_type=device.type)
    if sizes["data"] > 1:
        raise ValueError(
            f"the mesh {job.mesh!r} spans {sizes['data']} processes: "
            "training.launch.run starts them (or torchrun, with multihost)")
    if device.type == "cpu":
        devices = [device] * sizes["seq"]
    else:
        devices = mesh_lib.local_devices()
    return mesh_lib.make_mesh((1, sizes["seq"]), devices=devices)


def _per_process(n: int, world: int) -> int:
    """A global batch or accumulate count checked against the processes of
    a data-parallel run. The count stays GLOBAL: every process samples the
    same global batch and keeps its share, which divisibility is for."""
    if n % world:
        raise ValueError(f"global batch/accumulate {n} must divide the "
                         f"{world} processes of a data-parallel run")
    return n


def _loop_config(job: TrainJob, world: int = 1):
    from orca_tpu_torch.training.loop import LoopConfig

    return LoopConfig(
        workdir=job.workdir,
        lr=job.lr,
        batch_size=(_per_process(job.batch_size, world) if job.stage == "a"
                    else job.batch_size),
        checkpoint_every=job.checkpoint_every,
        validate_every=job.validate_every,
        val_batches=job.val_batches,
        max_steps=job.max_steps,
        use_swa=job.use_swa,
        seed=job.seed,
        num_workers=job.num_workers,
        loader_backend=job.loader_backend,
    )


# --------------------------------------------------------------------------
# Prior-stage parameter loading (cross-stage transfer)
# --------------------------------------------------------------------------


def _restore_raw(workdir: str, device) -> dict:
    """The latest checkpoint of a workdir of this package."""
    from orca_tpu_torch.training.loop import latest_checkpoint

    path = latest_checkpoint(workdir)
    if path is None:
        raise FileNotFoundError(
            f"no checkpoint (ckpt_<step>.pt) found in {workdir}; the JAX "
            "package's orbax checkpoints are not read")
    return torch.load(path, map_location=device, weights_only=True)


def _stage_a_params(job: TrainJob, device) -> dict:
    """Stage-a Net params used as the frozen tower and Decoder_1m of stages
    b/c (the SWA average when the run kept one)."""
    if job.init_workdir_a:
        state = _restore_raw(job.init_workdir_a, device)
        if "swa" in state:
            return state["swa"]["avg"]
        return state["params"]
    if job.init_statedict_dir:
        from orca_tpu_torch.models import convert

        sd = convert.load_statedict(os.path.join(
            job.init_statedict_dir, f"orca_{job.cell}.net0.statedict"
        ))
        return {
            "encoder": convert.convert_encoder_tower(sd, device=device),
            "decoder": convert.convert_decoder1m(sd, device=device),
        }
    raise ValueError(
        "stage b/c needs init_workdir_a or init_statedict_dir"
    )


def _stage_b_pyramid(job: TrainJob, device) -> dict:
    """Stage-b pyramid frozen into stage c."""
    if job.init_workdir_b:
        return _restore_raw(job.init_workdir_b, device)["trainable"]["pyramid"]
    if job.init_statedict_dir:
        from orca_tpu_torch.models import convert

        sd = convert.load_statedict(os.path.join(
            job.init_statedict_dir, f"orca_{job.cell}.net.statedict"
        ))
        return convert.convert_pyramid(sd, levels=5, up_pass=True,
                                       device=device)
    raise ValueError(
        "stage c needs init_workdir_b or init_statedict_dir"
    )


def _normmats_for_levels(expected_log, levels, bins, crop):
    from orca_tpu_torch.models.zoo import normmats_from_expectation

    normmats, epss = normmats_from_expectation(
        expected_log, levels=sorted(levels), nbins=bins, crop=crop
    )
    nm = np.stack([normmats[lv].astype(np.float32) for lv in levels])
    ep = np.array([epss[lv] for lv in levels], np.float32)
    return nm, ep


# --------------------------------------------------------------------------
# Trainer assembly
# --------------------------------------------------------------------------


def make_trainer(job: TrainJob, *, device=None):
    """The stage's trainer on `device` (None = CUDA), over the job's mesh
    (its state then on the first device of this process's row)."""
    if job.stage not in _STAGE_DEFAULTS:
        raise ValueError(f"unknown stage {job.stage!r} (a|b|c)")
    mesh = build_mesh(job, device=device)
    device = mesh.device() if mesh is not None else resolve_device(device)
    world = mesh.shape["data"] if mesh is not None else 1
    os.makedirs(job.workdir, exist_ok=True)
    return {"a": _make_stage_a, "b": _make_stage_b, "c": _make_stage_c}[
        job.stage
    ](job, device, mesh, world)


def _make_stage_a(job: TrainJob, device, mesh=None, world=1):
    from orca_tpu_torch.training.loop import StageATrainer
    from orca_tpu_torch.training.stages import StageAConfig

    window_bp, res, _, _ = _stage_geometry(job)
    crop = window_bp // 4000
    sampler = build_sampler(job)
    num_1d = sampler.target_1d.n_features if sampler.target_1d else None
    num_2d = len(_as_tuple(job.cooler_uri)) + len(_as_tuple(job.dense_store))
    cfg = StageAConfig(
        num_1d=num_1d, num_2d=num_2d, crop=crop, target_factor=4000 // res,
        seq_len=window_bp,
    )
    exp_paths = _as_tuple(job.expectation_npy)
    if len(exp_paths) != num_2d:
        raise ValueError(
            f"stage a needs one expectation_npy (res1000 expected) per 2D "
            f"target source: {len(exp_paths)} given, {num_2d} sources"
        )
    # ref: exp(load(res1000.npy))[:1000] -> 4x block average to 250
    # (train_h1esc_a.py:37-40,130-131); one background per head
    mats = []
    for path in exp_paths:
        e = np.load(path)[: window_bp // res]
        nb = len(e)
        normmat = np.exp(
            e[np.abs(np.arange(nb)[None] - np.arange(nb)[:, None])]
        )
        f = nb // crop
        mats.append(normmat.reshape(crop, f, crop, f).mean(axis=(1, 3)))
    normmat_r = np.stack(mats) if num_2d > 1 else mats[0]
    return StageATrainer(
        cfg, _loop_config(job, world), sampler,
        normmat_r.astype(np.float32), eps=float(normmat_r.min()),
        mesh=mesh, device=device,
    )


def _stage_b_levels_geom(window_bp):
    from orca_tpu_torch.predict.multiscale import CascadeGeometry

    geom = CascadeGeometry(window_bp=window_bp, bin_bp=4000,
                           crop=(window_bp // 4000) // 32)
    return (32, 16, 8, 4, 2, 1), geom


def _make_stage_b(job: TrainJob, device, mesh=None, world=1):
    from orca_tpu_torch.nn import decoders, encoders
    from orca_tpu_torch.nn.core import fold_params
    from orca_tpu_torch.training.loop import StageBTrainer
    from orca_tpu_torch.training.stages import StageBConfig

    window_bp, res, _, _ = _stage_geometry(job)
    levels, geom = _stage_b_levels_geom(window_bp)
    if job.levels:
        levels = tuple(job.levels)
        if any(a != 2 * b for a, b in zip(levels, levels[1:])):
            # the coarse prediction from level L is upsampled 2x by the
            # next decoder, which assumes the next level is L/2; other
            # subsets run but with spatially misaligned coarse context —
            # only meaningful for mechanics smoke tests
            import warnings

            warnings.warn(
                f"stage-b levels {levels} are not consecutive halvings; "
                "the coarse zoom context is spatially misaligned (fine "
                "for smoke tests, wrong for real training)",
                stacklevel=2,
            )
    num_2d = len(_as_tuple(job.cooler_uri)) + len(_as_tuple(job.dense_store))
    cfg = StageBConfig(geometry=geom, levels=levels,
                       encoder_block_bp=None if window_bp <= 2_000_000
                       else 800_000,
                       num_2d=num_2d, up_pass=job.pyramid_up_pass)
    sampler = build_sampler(job)

    a_params = _stage_a_params(job, device)
    frozen = {
        "encoder": fold_params(a_params["encoder"],
                               encoders.encoder_tower_spec()),
        "decoder_1pt": fold_params(a_params["decoder"],
                                   decoders.decoder1m_spec(num_2d)),
    }
    gen = torch.Generator(device=device).manual_seed(job.seed)
    trainable = {
        "pyramid": encoders.init_pyramid(gen, 5, job.pyramid_up_pass),
        "decoders": {lv: decoders.init_decoder(gen, num_2d=num_2d)
                     for lv in levels},
    }
    exp_paths = _as_tuple(job.expectation_npy)
    if len(exp_paths) != num_2d:
        raise ValueError(
            f"stage b needs one expectation_npy (res4000 expected) per 2D "
            f"target source: {len(exp_paths)} given, {num_2d} sources"
        )
    if num_2d == 1:
        expected_log = np.load(exp_paths[0])
        nm, ep = _normmats_for_levels(expected_log, levels, geom.bins,
                                      geom.crop)
    else:
        # multi-head backgrounds: (n_levels, num_2d, crop, crop)
        from orca_tpu_torch.models.zoo import multi_normmats_from_expectations

        normmats, epss = multi_normmats_from_expectations(
            [np.load(p) for p in exp_paths], levels=sorted(levels),
            nbins=geom.bins, crop=geom.crop,
        )
        nm = np.stack([normmats[lv].astype(np.float32) for lv in levels])
        ep = np.array([epss[lv] for lv in levels], np.float32)
    return StageBTrainer(
        cfg, _loop_config(job, world), sampler, trainable, frozen, nm, ep,
        accumulate=_per_process(job.accumulate, world), mesh=mesh,
        device=device,
    )


def _make_stage_c(job: TrainJob, device, mesh=None, world=1):
    from orca_tpu_torch.nn import decoders, encoders
    from orca_tpu_torch.nn.core import fold_params
    from orca_tpu_torch.predict.multiscale import CascadeGeometry
    from orca_tpu_torch.training.loop import StageCTrainer
    from orca_tpu_torch.training.stages import StageCConfig

    window_bp, res, _, _ = _stage_geometry(job)
    geom = CascadeGeometry(window_bp=window_bp, bin_bp=32_000,
                           crop=(window_bp // 32_000) // 32)
    levels = (256, 128, 64, 32)
    if job.levels:
        # stage-c factors are positional (bins/(crop*2^j)); only a prefix
        # of the full ladder keeps level<->factor consistent
        if tuple(job.levels) != levels[: len(job.levels)]:
            raise ValueError(
                f"stage-c levels must be a prefix of {levels}"
            )
        levels = tuple(job.levels)
    cfg = StageCConfig(geometry=geom, levels=levels,
                       encoder_block_bp=None if window_bp <= 2_000_000
                       else 800_000)
    sampler = build_sampler(job)

    a_params = _stage_a_params(job, device)
    frozen = {
        "encoder": fold_params(a_params["encoder"],
                               encoders.encoder_tower_spec()),
        "pyramid1": fold_params(_stage_b_pyramid(job, device),
                                encoders.pyramid_spec(5, True)),
    }
    gen = torch.Generator(device=device).manual_seed(job.seed)
    trainable = {
        "pyramid": encoders.init_pyramid(gen, 3, True),
        "decoders": {lv: decoders.init_decoder(gen) for lv in levels},
    }
    return StageCTrainer(
        cfg, _loop_config(job, world), sampler, trainable, frozen,
        accumulate=_per_process(job.accumulate, world), mesh=mesh,
        device=device,
    )


def run(job: TrainJob, *, device=None):
    """Assemble and run a training job on `device` (None = CUDA); resumes
    from the latest checkpoint in workdir when resume=True. A job whose
    mesh has data=N > 1 and no `multihost` runs as N processes started
    here; the result is process 0's."""
    data = mesh_sizes(job)["data"]
    if data > 1 and not job.multihost:
        return _spawn(job, device, data)
    trainer = make_trainer(job, device=device)
    if job.resume and trainer.try_restore():
        print(f"resumed from step {trainer.step} in {job.workdir}",
              flush=True)
    return trainer.run()


# --------------------------------------------------------------------------
# One command, N processes (what torchrun does for a multihost job)
# --------------------------------------------------------------------------


def _spawn(job: TrainJob, device, world: int):
    """Run `job` as `world` local processes of one data-parallel run, each
    with its slice of the devices and a localhost rendezvous; returns
    process 0's metrics. Raises when a process fails (the others are
    stopped) and, before starting any, when the host has too few CUDA
    devices or the batch does not divide."""
    import multiprocessing
    import socket
    from multiprocessing.connection import wait

    device = resolve_device(device)
    seq = mesh_sizes(job)["seq"]
    _per_process(job.batch_size if job.stage == "a" else job.accumulate,
                 world)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if world * seq > n:
            raise ValueError(f"{(world, seq)} needs {world * seq} devices, "
                             f"have {n}")
        # build the kernels once here, not in every process at once
        from orca_tpu_torch.ops.kernels import build

        build.build(["conv_chain"])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(rank, world, port, job, device, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        running = list(procs)
        while running:
            for sentinel in wait([p.sentinel for p in running]):
                p = next(q for q in running if q.sentinel == sentinel)
                p.join()
                running.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(
                        f"training process {procs.index(p)} of {world} "
                        f"exited with code {p.exitcode}")
        return results.get(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def _worker(rank: int, world: int, port: int, job: TrainJob, device,
            results) -> None:
    """One process of `_spawn`: torchrun's environment, then the job as one
    process of a multihost run."""
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    try:
        metrics = run(dataclasses.replace(job, multihost=True), device=device)
        if rank == 0:
            results.put({k: float(v) for k, v in (metrics or {}).items()})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
