"""Data-parallel training through the launch layer (training.launch.run,
the trainers' `mesh`, their checkpoints and logs) on the CPU, and a
two-card NCCL step on the card.

`launch.run` of a stage-b job with mesh "data=2" starts its two processes
itself (gloo on the CPU, a localhost rendezvous), as torchrun would; it runs
in a subprocess, `python tests/test_torch_multihost.py launch ...`, beside a
one-process run of the same job in this process.

Bars (float32, as the trainers run): every logged loss and validation MSE
within RTOL = 1e-4 relative of the one-process run's, the validation's
Pearson r within R_ATOL = 1e-3: the tower's CPU convs round by batch size
and BatchNorm statistics are summed in another order (2.4e-6 and 7.2e-6 at
steps 1 and 2, 1.4e-6 for the MSE, 7.9e-5 for r on 4 x 4 maps, measured).
The job's learning rate is 0, so the parameters move by their BatchNorm
running statistics alone: a float32 gradient at 4 x 4 decoder maps is
ill-conditioned (a 1e-7 relative change of the tower's features moved the
momentum's largest entry from 29.5 to 24.3, measured), and with any real
step the two runs' losses part by more than the summation order explains.
The update itself is held to the one-process step in float64 by
test_torch_multihost.py, to 1e-9.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_multihost import (
    REPO,
    TOL,
    _env,
    finish,
    leaf_err,
    start_ranks,
)

RTOL = 1e-4
R_ATOL = 1e-3
WORKER = os.path.join(REPO, "tests", "test_torch_multihost.py")

CHRLEN = 2_048_000
CHROMS = ("chr1", "chr2", "chr3")


def _train_job(tmp, workdir, **kw):
    rng = np.random.RandomState(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fasta = tmp / "genome.fa"
    if not fasta.exists():
        with open(fasta, "w") as f:
            for name in CHROMS:
                f.write(f">{name}\n")
                f.write(bases[rng.randint(0, 4, CHRLEN)].tobytes().decode())
                f.write("\n")
        nb = CHRLEN // 4000
        np.savez(tmp / "microc.npz", **{
            c: np.abs(rng.rand(nb, nb)).astype(np.float32) for c in CHROMS})
        np.save(tmp / "expected.npy",
                -1.5 * np.log1p(np.arange(nb, dtype=np.float64)) - 2.0)
        from orca_tpu_torch.nn import decoders as tdec

        os.makedirs(tmp / "a", exist_ok=True)
        params = tdec.init_net(torch.Generator().manual_seed(1), num_1d=None)
        torch.save({"params": params, "step": 1}, tmp / "a" / "ckpt_1.pt")
    job = dict(stage="b", workdir=str(workdir), genome_fasta=str(fasta),
               dense_store=str(tmp / "microc.npz"),
               expectation_npy=str(tmp / "expected.npy"),
               init_workdir_a=str(tmp / "a"), window_bp=512_000,
               levels=[32], accumulate=2, checkpoint_every=1,
               validate_every=2, val_batches=1, max_steps=2,
               validation_holdout=["chr3"], test_holdout=[], seed=7, lr=0.0)
    job.update(kw)
    return job


def _jsonl(workdir):
    with open(workdir / "stage_b.metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_launch_run_two_processes_equals_one(tmp_path):
    """`launch.run` of a stage-b job with mesh "data=2" starts two
    processes (gloo on the CPU): its losses and validation are the
    one-process run's; rank 0 alone writes each step's checkpoint and the
    metrics, every rank its `.p<rank>` sidecar (each rank's state was
    checked bit-identical to the others' before every save); a fresh
    one-process trainer restores the writer's params exactly."""
    from orca_tpu_torch.training import launch
    from orca_tpu_torch.utils.tree import tree_leaves

    job2 = _train_job(tmp_path, tmp_path / "two", mesh="data=2")
    path = tmp_path / "job2.json"
    path.write_text(json.dumps(job2))
    proc = subprocess.Popen(
        [sys.executable, WORKER, "launch", str(path),
         str(tmp_path / "two.json")], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        job1 = launch.TrainJob(**_train_job(tmp_path, tmp_path / "one"))
        one = launch.run(job1, device="cpu")
        finish([proc])
    finally:
        proc.kill()
    two = json.loads((tmp_path / "two.json").read_text())
    assert set(two) == set(one)
    rows1, rows2 = _jsonl(tmp_path / "one"), _jsonl(tmp_path / "two")
    assert [r["step"] for r in rows2] == [r["step"] for r in rows1] == [1, 2,
                                                                        2]
    for i, (r1, r2) in enumerate(zip(rows1, rows2)):
        assert set(r1) == set(r2)
        for k in set(r1) - {"step", "elapsed_s"}:
            bar = R_ATOL if "pearson" in k else RTOL * abs(r1[k])
            assert abs(r2[k] - r1[k]) <= bar, (i, k)
    for k, v in one.items():  # the last step's metrics, as run returns them
        assert abs(two[k] - float(v)) <= RTOL * abs(float(v)), k
    files = sorted(os.listdir(tmp_path / "two"))
    assert files == ["ckpt_1.host.p0.json", "ckpt_1.host.p1.json",
                     "ckpt_1.pt", "ckpt_2.host.p0.json",
                     "ckpt_2.host.p1.json", "ckpt_2.pt",
                     "stage_b.metrics.jsonl"]
    written = torch.load(tmp_path / "two" / "ckpt_2.pt", weights_only=True)
    fresh = launch.make_trainer(launch.TrainJob(
        **_train_job(tmp_path, tmp_path / "two")), device="cpu")
    initial = [t.clone() for t in tree_leaves(fresh.trainable)]
    assert fresh.try_restore() and fresh.step == 2
    leaves = tree_leaves(fresh.trainable)
    assert all(torch.equal(a, b) for a, b in zip(
        leaves, tree_leaves(written["trainable"])))
    assert any(not torch.equal(a, b) for a, b in zip(leaves, initial))


def test_launch_refuses_what_it_cannot_split(tmp_path, monkeypatch):
    """An indivisible batch, an unknown axis, too few cards and a
    one-process trainer handed a mesh of several rows are refused before
    any process starts; a failed rendezvous raises."""
    from orca_tpu_torch.parallel import mesh as tmesh
    from orca_tpu_torch.parallel import multihost
    from orca_tpu_torch.training import launch

    def job(**kw):
        return launch.TrainJob(**_train_job(tmp_path, tmp_path / "w", **kw))

    with pytest.raises(ValueError, match="must divide the 2 processes"):
        launch.run(job(mesh="data=2", accumulate=3), device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axes"):
        launch.run(job(mesh="date=2"), device="cpu")
    with pytest.raises(ValueError, match="spans 2 processes"):
        launch.make_trainer(job(mesh="data=2"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"\(2, 2\) needs 4 devices, have 1"):
        launch.run(job(mesh="data=2,seq=2"))
    monkeypatch.undo()
    from orca_tpu_torch.training import loop

    grid = tmesh.make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="one row of its mesh"):
        loop.StageCTrainer(None, None, None, {}, {}, mesh=grid, device="cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize(backend="gloo")


def test_launcher_reports_a_failed_process(tmp_path):
    """Processes that fail (here: no stage-a checkpoint to start from) make
    `run` raise, naming one, rather than return."""
    from orca_tpu_torch.training import launch

    job = launch.TrainJob(**_train_job(tmp_path, tmp_path / "w",
                                       mesh="data=2",
                                       init_workdir_a=str(tmp_path / "nope")))
    with pytest.raises(RuntimeError, match="training process . of 2 exited"):
        launch.run(job, device="cpu")




@pytest.mark.gpu
def test_two_card_nccl_stage_a_step(tmp_path):
    """Two ranks with nccl on cuda:0 and cuda:1: a float64 stage-a step on
    each rank's row, the port's own draws, equals the one-process step on
    the whole batch on cuda:0 (TOL, as on the CPU)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    finish(start_ranks("nccl", tmp_path))
    with open(tmp_path / "nccl.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["device"] == "cuda:0"
    (p_dp, t_dp, m_dp), (p_one, t_one, m_one) = out["dp"], out["one"]
    assert leaf_err(p_one, p_dp) <= TOL
    assert leaf_err(t_one, t_dp) <= TOL
    for k, v in m_one.items():
        assert abs(m_dp[k] - v) <= TOL * max(1.0, abs(v)), k
