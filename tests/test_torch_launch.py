"""The port's training launch layer (orca_tpu_torch.training.launch) and the
command line's `train` (orca_tpu_torch.cli), on the CPU.

`TrainJob` reads the JAX package's job files to the same fields, with the
same overrides and validation. `run(job, device="cpu")` chains the three
stages on synthetic resources at scaled windows, as the JAX package's
tests/test_launch.py does: stage a trains the 1 Mb Net (40 kb windows), stage
b freezes its tower and Decoder_1m (1.024 Mb, levels (32, 1)), stage c
freezes the stage-b pyramid (2.048 Mb, four levels), each starting from the
previous stage's `ckpt_<step>.pt`. The command line's `train` is held to the
JAX package's action through one recorder in place of both packages' `run`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from orca_tpu import cli as jcli
from orca_tpu.training import launch as jlaunch
from orca_tpu_torch import cli as tcli
from orca_tpu_torch.models import convert
from orca_tpu_torch.nn import decoders as tdec
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.training import launch as tlaunch
from orca_tpu_torch.training.loop import restore_state
from orca_tpu_torch.utils.tree import tree_leaves
from test_torch_encoders import share_cpu_with_other_workers

share_cpu_with_other_workers()

CHRLEN = 2_048_000
CHROMS = ("chr1", "chr2", "chr3")


def test_trainjob_from_json_equals_jax_package(tmp_path):
    path = tmp_path / "job.json"
    path.write_text(json.dumps({
        "stage": "a", "workdir": "/tmp/x", "levels": [32, 1],
        "validation_holdout": ["chr2"], "dense_store": ["a.npz", "b.npz"],
        "expectation_npy": "e.npy", "mesh": "",
    }))
    overrides = dict(max_steps=7, workdir=None, use_swa=True, seed=None)
    want = jlaunch.TrainJob.from_json(str(path), **overrides)
    got = tlaunch.TrainJob.from_json(str(path), **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_steps == 7 and got.workdir == "/tmp/x"
    assert got.levels == (32, 1) and got.validation_holdout == ("chr2",)
    assert ([f.name for f in dataclasses.fields(tlaunch.TrainJob)]
            == [f.name for f in dataclasses.fields(jlaunch.TrainJob)])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"stage": "a", "workdir": "x", "nope": 1}))
    for pkg in (jlaunch, tlaunch):
        with pytest.raises(ValueError, match="nope"):
            pkg.TrainJob.from_json(str(bad))


def test_mesh_and_multihost_name_a16(monkeypatch):
    """The job's mesh: none without a spec, an unknown axis refused, a
    one-process (1, seq) mesh for seq alone (the CPU named seq times), a
    'data' axis of 2 refused inside one process (launch.run starts the
    processes), and `multihost` needs torchrun's environment."""
    assert tlaunch.build_mesh(tlaunch.TrainJob(stage="a", workdir="x")) is None
    with pytest.raises(ValueError, match="date"):
        tlaunch.build_mesh(tlaunch.TrainJob(stage="a", workdir="x",
                                            mesh="date=4,seq=2"))
    mesh = tlaunch.build_mesh(tlaunch.TrainJob(stage="b", workdir="x",
                                               mesh="seq=2"), device="cpu")
    assert mesh.shape == {"data": 1, "seq": 2} and mesh.data_group is None
    assert mesh.devices == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match="spans 2 processes"):
        tlaunch.make_trainer(tlaunch.TrainJob(stage="b", workdir="x",
                                              mesh="data=2"), device="cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tlaunch.make_trainer(tlaunch.TrainJob(stage="b", workdir="x",
                                              multihost=True), device="cpu")


def test_run_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.run(tlaunch.TrainJob(stage="a", workdir=str(tmp_path)))


# --------------------------------------------------------------------------
# the three stages chained on synthetic resources
# --------------------------------------------------------------------------


def _write_fasta(path, rng):
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for name in CHROMS:
            f.write(f">{name}\n")
            f.write(bases[rng.randint(0, 4, CHRLEN)].tobytes().decode())
            f.write("\n")


def _write_dense_store(path, res, rng):
    nb = CHRLEN // res
    np.savez(path, **{c: np.abs(rng.rand(nb, nb)).astype(np.float32)
                      for c in CHROMS})


def _write_expectation(path, nbins):
    np.save(path, -1.5 * np.log1p(np.arange(nbins, dtype=np.float64)) - 2.0)


@pytest.fixture(scope="module")
def resources(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(0)
    _write_fasta(tmp / "genome.fa", rng)
    for res in (1000, 4000, 32000):
        _write_dense_store(tmp / f"microc_{res}.npz", res, rng)
    _write_expectation(tmp / "expected.res1000.npy", 2048)
    _write_expectation(tmp / "expected.res4000.npy", 512)
    d = np.arange(64, dtype=np.float64)
    np.save(tmp / "expected.res32000.mono.npy", -1.2 * np.log1p(d) - 3.0)
    np.save(tmp / "expected.res32000.trans.npy", np.float64(-9.0))
    (tmp / "tracks.bed").write_text("".join(
        f"{c}\t{s}\t{s + 30000}\ttrack{i}\n"
        for c in CHROMS for i, s in ((0, 10000), (1, 200000))))
    (tmp / "tracks.features").write_text("track0\ntrack1\n")
    return tmp


def _job(resources, stage, **kw):
    common = dict(genome_fasta=str(resources / "genome.fa"),
                  validation_holdout=("chr3",), test_holdout=(),
                  checkpoint_every=1, validate_every=100)
    common.update(kw)
    return tlaunch.TrainJob(stage=stage, **common)


def test_run_stages_a_b_c_chained(resources, tmp_path):
    """Each stage trains from the previous stage's checkpoint; stage a
    resumes; the frozen parts of b and c are the earlier stages' folded
    params (a's SWA average), bit for bit."""
    r = resources
    job_a = _job(r, "a", workdir=str(tmp_path / "a"),
                 dense_store=str(r / "microc_1000.npz"),
                 bed_path=str(r / "tracks.bed"),
                 bed_features=str(r / "tracks.features"),
                 expectation_npy=str(r / "expected.res1000.npy"),
                 window_bp=40_000, batch_size=2, max_steps=2, use_swa=True,
                 validate_every=2, val_batches=1)
    metrics = tlaunch.run(job_a, device="cpu")
    assert {"loss", "loss1d", "loss2d"} <= set(metrics)
    assert os.path.exists(tmp_path / "a" / "ckpt_2.pt")
    job_a.max_steps = 3
    tlaunch.run(job_a, device="cpu")  # resumes from step 2
    state_a = restore_state(str(tmp_path / "a"), "cpu")
    assert state_a["step"] == 3 and state_a["swa"]["n"] == 3

    job_b = _job(r, "b", workdir=str(tmp_path / "b"),
                 dense_store=str(r / "microc_4000.npz"),
                 expectation_npy=str(r / "expected.res4000.npy"),
                 init_workdir_a=str(tmp_path / "a"), window_bp=1_024_000,
                 levels=(32, 1), accumulate=1, max_steps=1)
    trainer_b = tlaunch.make_trainer(job_b, device="cpu")
    folded = fold_params(state_a["swa"]["avg"], tdec.net_spec(2))
    for a, b in zip(tree_leaves(folded["encoder"]),
                    tree_leaves(trainer_b.frozen["encoder"])):
        assert torch.equal(a, b)
    assert np.isfinite(float(trainer_b.run()["loss"]))
    assert os.path.exists(tmp_path / "b" / "ckpt_1.pt")

    job_c = _job(r, "c", workdir=str(tmp_path / "c"),
                 dense_store=str(r / "microc_32000.npz"),
                 background_cis_npy=str(r / "expected.res32000.mono.npy"),
                 background_trans_npy=str(r / "expected.res32000.trans.npy"),
                 init_workdir_a=str(tmp_path / "a"),
                 init_workdir_b=str(tmp_path / "b"), window_bp=2_048_000,
                 accumulate=1, max_steps=1)
    trainer_c = tlaunch.make_trainer(job_c, device="cpu")
    pyramid_b = restore_state(str(tmp_path / "b"), "cpu")["trainable"][
        "pyramid"]
    for a, b in zip(tree_leaves(fold_params(pyramid_b,
                                            tenc.pyramid_spec(5, True))),
                    tree_leaves(trainer_c.frozen["pyramid1"])):
        assert torch.equal(a, b)
    metrics = trainer_c.run()
    assert set(metrics) == {"loss"} | {f"loss_{lv}"
                                       for lv in (256, 128, 64, 32)}
    assert os.path.exists(tmp_path / "c" / "ckpt_1.pt")


def test_stage_b_starts_from_released_statedicts(resources, tmp_path):
    """init_statedict_dir: the stage-a Net read from the reference's
    statedict layout by the ported converter, folded into the frozen tower;
    an orbax workdir is refused by name."""
    gen = torch.Generator().manual_seed(4)
    net = tdec.init_net(gen, num_1d=None)
    sd_dir = tmp_path / "models"
    sd_dir.mkdir()
    torch.save(convert.net_statedict(net),
               sd_dir / "orca_h1esc.net0.statedict")
    r = resources
    job = _job(r, "b", workdir=str(tmp_path / "b"),
               dense_store=str(r / "microc_4000.npz"),
               expectation_npy=str(r / "expected.res4000.npy"),
               init_statedict_dir=str(sd_dir), window_bp=1_024_000,
               levels=(32, 1), accumulate=1, max_steps=1)
    trainer = tlaunch.make_trainer(job, device="cpu")
    want = fold_params(net["encoder"], tenc.encoder_tower_spec())
    for a, b in zip(tree_leaves(want), tree_leaves(trainer.frozen["encoder"])):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    (tmp_path / "orbax" / "ckpt_5").mkdir(parents=True)
    job.init_workdir_a, job.init_statedict_dir = str(tmp_path / "orbax"), None
    with pytest.raises(FileNotFoundError, match="orbax"):
        tlaunch.make_trainer(job, device="cpu")


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

ARGVS = [
    ["train", "a", "--config", "JOB"],
    ["train", "b", "--config", "JOB", "--workdir", "/w", "--max-steps", "9",
     "--swa", "--workers", "3", "--seed", "5", "--no-resume"],
    ["train", "c", "--config", "JOB", "--max-steps", "1"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["a", "b_flags", "c"])
def test_cli_train_equal(argv, tmp_path, monkeypatch, capsys):
    """Both packages' `train` build the same TrainJob from a job file and
    flags, pass it to `run`, and print the returned metrics alike."""
    path = tmp_path / "job.json"
    path.write_text(json.dumps({"workdir": str(tmp_path / "w0"),
                                "window_bp": 40_000, "batch_size": 2}))
    argv = [str(path) if a == "JOB" else a for a in argv]
    seen = {}

    def recorder(pkg):
        def run(job, device=None):
            seen[pkg] = (dataclasses.asdict(job), device)
            return {"loss": np.float32(1.5)}
        return run

    monkeypatch.setattr(jlaunch, "run", recorder("jax"))
    monkeypatch.setattr(tlaunch, "run", recorder("torch"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    said = {}
    for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
        assert main(argv) == 0
        said[pkg] = capsys.readouterr().out
    assert seen["torch"][0] == seen["jax"][0]
    assert seen["torch"][1] is None  # the card
    assert said["torch"] == said["jax"] == "{'loss': 1.5}\n"


def test_cli_train_refuses_without_cuda_or_with_a_mesh(tmp_path, monkeypatch,
                                                       capsys):
    """`train` refuses without CUDA; `--mesh` and a job file's mesh reach
    the TrainJob that `run` takes; an unknown axis is a usage error."""
    path = tmp_path / "job.json"
    path.write_text(json.dumps({"workdir": str(tmp_path / "w")}))
    monkeypatch.setattr(tlaunch, "run", lambda job, device=None: {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["train", "a", "--config", str(path)])
    assert e.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    monkeypatch.setattr(tlaunch, "run",
                        lambda job, device=None: seen.append(job.mesh) or {})
    assert tcli.main(["train", "b", "--config", str(path), "--mesh",
                      "data=2,seq=2"]) == 0
    path.write_text(json.dumps({"workdir": str(tmp_path / "w"),
                                "mesh": "data=2"}))
    assert tcli.main(["train", "b", "--config", str(path)]) == 0
    assert seen == ["data=2,seq=2", "data=2"]
    with pytest.raises(SystemExit) as e:
        tcli.main(["train", "b", "--config", str(path), "--mesh", "date=2"])
    assert e.value.code == 2 and "unknown mesh axes" in capsys.readouterr().err
