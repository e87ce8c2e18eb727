"""The port stands alone: orca_tpu_torch, chip_smoke.py and the port's card
scripts import neither JAX nor anything of orca_tpu, every driver of the
JAX package has its counterpart in the port or a reason why not, the port's
entry points (load_resources, the process_* pipelines and the scripts
included) run on CUDA unless the caller asks for the CPU, the prediction API and the plots import without
matplotlib, and a 256 Mb bundle pickled by the JAX package loads into the
port's class without it. Every public name an `orca_tpu/**/__init__.py`
binds exists on the matching orca_tpu_torch module, and `set_config`
installs the configuration `get_config` returns."""

import ast
import os
import re
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "orca_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "orca_tpu", "flax", "optax", "ml_dtypes"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "scripts" / "bench_conv_chain.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_orca_tpu_import_in_source(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_command_line_and_1m_family_are_checked_sources():
    """The command line, the 1 Mb family, the expectation files module and
    the training path are among the sources held to the rule above."""
    sources = set(_port_sources())
    for rel in ("cli.py", "predict/onemb.py", "data/expectation.py",
                "models/convert.py", "training/stages.py", "training/loop.py",
                "training/launch.py", "training/losses.py",
                "training/optim.py", "training/swa.py", "utils/rng.py",
                "utils/logging.py", "data/sampler.py", "data/pipeline.py",
                "parallel/mesh.py", "parallel/sequence.py",
                "utils/profiling.py", "data/native.py", "bench.py",
                "bench_training.py", "scripts/_common.py",
                "scripts/bench_serve_screen.py", "scripts/measure_loader.py",
                "scripts/profile_cascade.py", "scripts/probe_two_model.py",
                "scripts/probe_decoder.py", "scripts/smoke_e2e.py",
                "scripts/bench_256m.py"):
        assert PORT / rel in sources, rel


# The modules of orca_tpu with no counterpart in the port, each with why.
UNPORTED = {
    "certify.py": "ROADMAP A17: both modes drive the original Orca's torch "
                  "modules from a reference checkout the repository lacks",
    "ops/pallas/__init__.py": "the Pallas kernels' package: its kernels are "
                              "ported into csrc/conv_chain.cu",
    "ops/pallas/conv1d.py": "ported into csrc/conv_chain.cu behind "
                            "ops/kernels/conv_chain.py",
}
JAX_MODULES = sorted(str(p.relative_to(REPO / "orca_tpu"))
                     for p in (REPO / "orca_tpu").rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_has_a_counterpart(rel):
    """Each module of orca_tpu has one at the same path in orca_tpu_torch,
    or is listed in UNPORTED with its reason (and then has none)."""
    assert (PORT / rel).exists() != (rel in UNPORTED), rel


def test_unported_modules_are_jax_modules():
    assert sorted(UNPORTED) == sorted(set(UNPORTED) & set(JAX_MODULES))


# The JAX package's drivers with no counterpart in the port, each with why.
UNPORTED_SCRIPTS = {
    "scripts/baseline_torch.py": "drives the original Orca's torch modules "
                                 "from a reference checkout the repository "
                                 "lacks (ROADMAP A17's blocker)",
    "scripts/profile_compile.py": "times XLA's lowering and compilation; the "
                                  "port compiles nothing but its nvcc build, "
                                  "which bench's compile_s reports",
    "scripts/profile_pallas_compile.py": "times the Pallas kernels' lowering "
                                         "and compilation, as above",
    "scripts/probe_stage_kernels.py": "times the Pallas kernels per stage: "
                                      "chip_smoke.py phase 3's stage lines "
                                      "and scripts/bench_conv_chain.py do "
                                      "that for the CUDA kernels",
}
JAX_SCRIPTS = sorted(
    str(p.relative_to(REPO)) for p in [REPO / "bench.py",
                                       *(REPO / "scripts").glob("*.py")]
    if "orca_tpu" in _imported_roots(p))
SCRIPT_COUNTERPARTS = {"bench.py": "bench.py",
                       "scripts/bench_training.py": "bench_training.py"}


@pytest.mark.parametrize("rel", JAX_SCRIPTS)
def test_every_jax_script_has_a_counterpart(rel):
    """Each driver of the JAX package (bench.py, and each scripts/*.py that
    imports orca_tpu) has its counterpart in the port (orca_tpu_torch/
    bench.py, bench_training.py or scripts/<name>), or is listed in
    UNPORTED_SCRIPTS with its reason (and then has none)."""
    counterpart = PORT / SCRIPT_COUNTERPARTS.get(rel, rel)
    assert counterpart.exists() != (rel in UNPORTED_SCRIPTS), rel


def test_unported_scripts_are_jax_scripts():
    assert len(JAX_SCRIPTS) == 13
    assert sorted(UNPORTED_SCRIPTS) == sorted(
        set(UNPORTED_SCRIPTS) & set(JAX_SCRIPTS))


@pytest.mark.parametrize("path", sorted(p for p in PORT.rglob("*")
                                        if p.suffix in (".py", ".cu", ".cpp")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_names_the_native_directory(path):
    """The port builds its codec from csrc/orca_native.cpp: no source of it
    names the JAX package's native/ directory or its library there."""
    text = path.read_text()
    assert not re.search(r"(?<![\w.])native[/\\]", text)
    if path.suffix == ".py":
        assert not [n for n in ast.walk(ast.parse(text, str(path)))
                    if isinstance(n, ast.Constant) and n.value == "native"]


def _bound_names(path):
    """The public names an __init__.py's own statements bind."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_"))


JAX_INITS = sorted((REPO / "orca_tpu").rglob("__init__.py"))


@pytest.mark.parametrize("path", JAX_INITS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_has_every_public_reexport(path):
    """A user who switches `import orca_tpu...` to `import
    orca_tpu_torch...` finds every name the JAX package's __init__.py binds
    (an empty __init__.py binds none, and needs no counterpart)."""
    import importlib

    names = _bound_names(path)
    if not names:
        return
    rel = path.parent.relative_to(REPO / "orca_tpu")
    module = importlib.import_module(".".join(("orca_tpu_torch",) + rel.parts))
    assert [n for n in names if not hasattr(module, n)] == []


def test_set_config_is_what_get_config_returns():
    import dataclasses

    from orca_tpu_torch import get_config, set_config, OrcaConfig

    old = get_config()
    try:
        mine = OrcaConfig(param_dtype="bfloat16", encoder_halo_bp=116_000)
        set_config(mine)
        assert get_config() is mine
        set_config(dataclasses.replace(mine, kernel_block_bp=2_000_000))
        assert get_config().kernel_block_bp == 2_000_000
        assert get_config().param_dtype == "bfloat16"
    finally:
        set_config(old)
    assert get_config() is old


def test_cli_help_runs_with_jax_blocked():
    """`python -m orca_tpu_torch.cli --help` works where jax and orca_tpu
    cannot be imported."""
    code = (
        "import runpy, sys\n"
        "for name in %r:\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['orca-tpu-torch', '--help']\n"
        "runpy.run_module('orca_tpu_torch.cli', run_name='__main__')\n"
        % (sorted(FORBIDDEN),)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("usage: orca-tpu-torch")
    for sub in ("region", "break", "build-genome", "expectation", "serve"):
        assert sub in proc.stdout


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import orca_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    orca_tpu_torch.__path__, 'orca_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 10 else 0)\n" % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from orca_tpu_torch.models import zoo
    from orca_tpu_torch.predict import multiscale

    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.random_32m_bundle(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.random_256m_bundle(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        multiscale.genomepredict(None, "chr1", models=())
    with pytest.raises(RuntimeError, match="CUDA"):
        multiscale.genomepredict_256mb(None, "chr1", [], 0, models=())
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.load_bundle("unused.bundle")
    from orca_tpu_torch import bench

    with pytest.raises(RuntimeError, match="CUDA"):
        bench._measure("bfloat16", None, 0, 0, 1)


def test_1m_family_and_warmups_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from orca_tpu_torch.models import zoo
    from orca_tpu_torch.predict import multiscale, onemb

    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.random_1m_bundle(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        onemb.predict_1m(None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        onemb.screen_windows(None, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        multiscale.warmup_cascade_32m(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        multiscale.warmup_cascade_256m(None)
    bundle = zoo.random_1m_bundle(0, num_1d=None, device="cpu")
    assert isinstance(bundle, zoo.Model1MBundle)
    assert bundle.net["encoder"]["lconv"][0][0]["w"].device.type == "cpu"


def test_converter_and_loaders_need_cuda_unless_told_cpu():
    """The statedict converters, the statedict loaders and the leukemia
    family's random bundle take device=None as CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from orca_tpu_torch.models import convert, zoo
    from orca_tpu_torch.nn import decoders

    head = decoders.final1d_spec(4)
    params = [{"w": torch.zeros(1, 128, 128), "b": torch.zeros(128),
               "bn": {k: torch.ones(128) for k in ("scale", "bias", "mean",
                                                  "var")}},
              {"w": torch.zeros(1, 128, 4), "b": torch.zeros(4)}]
    sd = convert.block_statedict(params, "final_1d.", head)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.convert_block(sd, "final_1d.", head)
    got = convert.convert_block(sd, "final_1d.", head, device="cpu")
    assert got[1]["w"].device.type == "cpu"
    for loader in (zoo.load_32m_bundle, zoo.load_256m_bundle,
                   zoo.load_1m_bundle, zoo.load_leukemia_bundle):
        with pytest.raises(RuntimeError, match="CUDA"):
            loader("unused", "unused", "h1esc")
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.random_leukemia_bundle(0)


class _ReachedTheCascade(Exception):
    pass


def test_resources_and_pipelines_need_cuda_unless_told_cpu(tmp_path,
                                                           monkeypatch):
    """load_resources and the process_* pipelines raise without CUDA unless
    given device='cpu', which a pipeline passes on to the cascade."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from orca_tpu_torch.predict import multiscale, pipelines, resources

    with pytest.raises(RuntimeError, match="CUDA"):
        resources.load_resources(models=(), model_dir=str(tmp_path),
                                 resource_dir=str(tmp_path))
    res = resources.load_resources(models=(), model_dir=str(tmp_path),
                                   resource_dir=str(tmp_path), device="cpu")
    assert res.models == {} and res.genome is None

    def reached(sequence, device):
        raise _ReachedTheCascade(str(device))

    monkeypatch.setattr(multiscale, "_device_sequence", reached)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipelines.process_seqstr("ACGT" * 100, 50, None, [],
                                 window_radius=1000)
    with pytest.raises(_ReachedTheCascade, match="cpu"):
        pipelines.process_seqstr("ACGT" * 100, 50, None, [],
                                 window_radius=1000, device="cpu")


def test_predict_and_viz_import_without_matplotlib():
    """The card's machine has no matplotlib: the prediction API and the
    plotting module import without it (matplotlib is needed only to draw)."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import orca_tpu_torch.predict, orca_tpu_torch.viz\n"
        "import orca_tpu_torch.colormaps\n"
        "from orca_tpu_torch.predict import pipelines\n"
        "pipelines._maybe_plot({}, None, '', pipelines.WR32, None)\n"
        "try:\n"
        "    orca_tpu_torch.viz.contact_cmap()\n"
        "except ImportError:\n"
        "    print('drawing needs matplotlib')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "drawing needs matplotlib"


@pytest.fixture(scope="module")
def jax_256m_pickle(tmp_path_factory):
    """(path, JAX bundle) of a JAX-package Model256MBundle (parameters drawn
    with numpy, BatchNorm unfolded) pickled by its `zoo.save_bundle`."""
    import numpy as np

    from orca_tpu.models import zoo as jzoo
    from orca_tpu.nn import decoders as jdec
    from orca_tpu.nn import encoders as jenc
    from test_torch_encoders import numpy_tree

    rng = np.random.RandomState(3)
    bundle = jzoo.Model256MBundle(
        name="numpy256",
        encoder=numpy_tree(jenc.encoder_tower_spec(), rng),
        pyramid1=numpy_tree(jenc.pyramid_spec(5, True), rng),
        pyramid=numpy_tree(jenc.pyramid_spec(3, True), rng),
        decoders={lv: numpy_tree(jdec.decoder_spec(1), rng)
                  for lv in jzoo.LEVELS_256M},
        background_cis=np.hstack([np.exp(-np.arange(80.0)),
                                  np.repeat(np.nan, 20)]),
        background_trans=float(np.exp(-9.0)),
        upsample_mode="nearest",
    )
    path = str(tmp_path_factory.mktemp("bundle") / "orca_random_256m.bundle")
    jzoo.save_bundle(bundle, path)
    return path, bundle


def test_load_256m_bundle_needs_cuda_unless_told_cpu(jax_256m_pickle):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from orca_tpu_torch.models import zoo

    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.load_bundle(jax_256m_pickle[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_256m_bundle_round_trip(jax_256m_pickle, dtype):
    """A JAX-package Model256MBundle pickle loads into the port's class, with
    every parameter equal (rounded once to bf16 for 'bfloat16') and the
    backgrounds unchanged."""
    import jax
    import numpy as np

    from orca_tpu_torch.models import zoo

    path, want = jax_256m_pickle
    got = zoo.load_bundle(path, device="cpu", dtype=dtype)
    assert isinstance(got, zoo.Model256MBundle)
    assert got.name == want.name and got.levels == zoo.LEVELS_256M
    assert got.upsample_mode == want.upsample_mode
    np.testing.assert_array_equal(got.background_cis, want.background_cis)
    assert got.background_trans == want.background_trans
    for field in ("encoder", "pyramid1", "pyramid", "decoders"):
        w = jax.tree.leaves(getattr(want, field))
        g = jax.tree.leaves(getattr(got, field))
        assert len(g) == len(w) > 0, field
        for a, b in zip(g, w):
            assert a.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(
                a.float().numpy(),
                torch.tensor(b).to(getattr(torch, dtype)).float().numpy())


def test_training_entry_points_need_cuda_unless_told_cpu(tmp_path):
    """launch.run, the stage trainers and the stage steps' makers take
    device=None as CUDA and raise without it; device='cpu' runs there."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    import numpy as np

    from orca_tpu_torch.training import launch, loop, stages

    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run(launch.TrainJob(stage="a", workdir=str(tmp_path)))
    for make in (stages.make_stage_a_step, stages.make_stage_b_step,
                 stages.make_stage_b_eval, stages.make_stage_c_step,
                 stages.make_stage_c_eval):
        cfg = (stages.StageAConfig() if make is stages.make_stage_a_step
               else stages.StageBConfig() if "_b_" in make.__name__
               else stages.StageCConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            make(cfg)
        assert make(cfg, device="cpu") is not None
    lc = loop.LoopConfig(workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.StageATrainer(stages.StageAConfig(), lc, None,
                           np.ones((250, 250)), 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.StageBTrainer(stages.StageBConfig(), lc, None, {}, {},
                           np.ones((6, 250, 250)), np.ones(6))
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.StageCTrainer(stages.StageCConfig(), lc, None, {}, {})
    from orca_tpu_torch import bench_training

    with pytest.raises(RuntimeError, match="CUDA"):
        bench_training.bench_stage_a()


def test_scripts_need_cuda_unless_told_cpu():
    """Every script's entry point takes device=None as CUDA and raises
    without it, before it builds or starts anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from orca_tpu_torch import bench_training
    from orca_tpu_torch.scripts import (
        bench_256m,
        bench_serve_screen,
        measure_loader,
        probe_decoder,
        probe_two_model,
        profile_cascade,
        smoke_e2e,
    )

    for fn in (bench_serve_screen.main, measure_loader.main,
               bench_training.bench_encoder_paths, profile_cascade.main,
               probe_two_model.main, probe_decoder.main, smoke_e2e.main,
               bench_256m.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
