"""The port stands alone: orca_tpu_torch, chip_smoke.py and the port's card
scripts import neither JAX nor anything of orca_tpu, every driver of the
JAX package has its counterpart in the port or a reason why not, the port's
entry points (load_resources, the process_* pipelines and the scripts
included) run on CUDA unless the caller asks for the CPU, the prediction API and the plots import without
matplotlib, and a 256 Mb bundle pickled by the JAX package loads into the
port's class without it. Every public name an `orca_tpu/**/__init__.py`
binds exists on the matching orca_tpu_torch module, and `set_config`
installs the configuration `get_config` returns. Every public function and
class of an orca_tpu module with a counterpart takes JAX's arguments in
JAX's positions in the port, the exemptions listed with their reasons."""

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


# --------------------------------------------------------------------------
# Signatures: code written for orca_tpu calls the port with the same
# arguments. For each public function and class of each JAX module with a
# counterpart, JAX's positional parameters sit at the same positions in the
# port, every JAX parameter is accepted, and the port's own additions
# (device, the port's Mesh, a torch.Generator, a data-parallel group) come
# after JAX's, keyword-only. The exemptions, each with its reason:
# --------------------------------------------------------------------------

_GEN = ("initial parameters are drawn from a torch.Generator, which the port "
        "takes in the JAX key's place")
_DTYPE = ("the port initialises in float32; a bundle is cast after "
          "(zoo.cast_bundle)")
_ORCA_XLA = ("the XLA path's block of the JAX tower; the port runs one tower "
             "path, blocked by kernel_block_bp")
# (JAX module, name) -> {JAX parameter: why the port does not take it as JAX
# does}
EXEMPT_PARAMS = {
    ("nn/core.py", "init_block"): {"rng": _GEN, "dtype": _DTYPE},
    ("nn/encoders.py", "init_encoder_tower"): {"rng": _GEN, "dtype": _DTYPE},
    ("nn/encoders.py", "init_pyramid"): {"rng": _GEN, "dtype": _DTYPE},
    ("nn/decoders.py", "init_decoder"): {"rng": _GEN, "dtype": _DTYPE},
    ("nn/decoders.py", "init_decoder1m"): {"rng": _GEN, "dtype": _DTYPE},
    ("nn/decoders.py", "init_net"): {"rng": _GEN, "dtype": _DTYPE},
    ("ops/nn_ops.py", "dropout"): {
        "rng": "masks are drawn in nn.core.apply_unit from the unit's key; "
               "the port's dropout takes the mask in the key's place"},
    ("nn/encoders.py", "apply_encoder_tower"): {
        "checkpoint_blocks": "no caller in either package "
                             "(orca_tpu/nn/encoders.py:302, :454)"},
    ("training/loop.py", "restore_state"): {
        "template": "an orbax restore template; the port's checkpoints are "
                    "torch files, which need none"},
    ("utils/config.py", "OrcaConfig"): {
        "encoder_block_bp": _ORCA_XLA,
        "pallas_block_bp": "the Pallas tower's block; the port's "
                           "counterpart is kernel_block_bp",
        "interpret_pallas": "runs the Pallas kernels in interpret mode; the "
                            "port's kernels are CUDA, with plain versions "
                            "on the CPU",
        "use_pallas": "chooses between the XLA and Pallas towers; the port "
                      "has one tower"},
}
# (JAX module, name) -> why the port has no such function
EXEMPT_NAMES = {
    ("nn/encoders.py", "apply_encoder_stages_pallas"):
        "the TPU's Pallas stages; the port's fused CUDA stages run inside "
        "apply_encoder_tower",
    ("nn/encoders.py", "pallas_encoder_enabled"):
        "whether the TPU's Pallas tower runs; the port's tower always runs "
        "its CUDA kernels on the card",
    ("utils/profiling.py", "annotate"):
        "the port's `span` labels a region of a trace, and also times it "
        "on the host when the program's spans are on",
}


def _jax_public(rel):
    """The public functions and classes a JAX module defines (parsed, not
    imported)."""
    tree = ast.parse((REPO / "orca_tpu" / rel).read_text())
    return sorted(n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_"))


SIGNED = [(rel, name) for rel in JAX_MODULES if rel not in UNPORTED
          for name in _jax_public(rel)]


def _module(package, rel):
    import importlib

    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join([package, *parts]))


def _signature_faults(jax_obj, port_obj, exempt):
    """The ways `port_obj` does not take `jax_obj`'s arguments, `exempt`'s
    parameters aside: [] when a call written for JAX binds the same."""
    import inspect

    P = inspect.Parameter
    positional = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
    jp = inspect.signature(jax_obj).parameters
    tp = inspect.signature(port_obj).parameters
    jpos = [n for n, p in jp.items() if p.kind in positional]
    tpos = [n for n, p in tp.items() if p.kind in positional]
    faults = [f"{name!r} is not an exempt JAX parameter" for name in exempt
              if name not in jp]
    # each of the port's positions is JAX's there, or stands in for an
    # exempt one; the port's own parameters are keyword-only
    for i, name in enumerate(tpos):
        if i >= len(jpos):
            faults.append(f"{name!r} is positional past JAX's {len(jpos)}")
        elif name != jpos[i] and jpos[i] not in exempt:
            faults.append(f"position {i} is {name!r}, JAX's is {jpos[i]!r}")
    # JAX's positions hold JAX's names; after an exempt parameter the port
    # lacks, later positions cannot match, so those names are keyword-only
    shifted = False
    for i, name in enumerate(jpos):
        if name in exempt:
            shifted = shifted or i >= len(tpos)
        elif shifted:
            if name not in tp or tp[name].kind != P.KEYWORD_ONLY:
                faults.append(f"{name!r} is not keyword-only after a shift")
        elif i >= len(tpos) or tpos[i] != name:
            faults.append(f"JAX's {name!r} is not at position {i}")
    takes_any = any(p.kind == P.VAR_KEYWORD for p in tp.values())
    for name, p in jp.items():
        if p.kind == P.KEYWORD_ONLY and name not in exempt and not (
                name in tp or takes_any):
            faults.append(f"JAX's keyword {name!r} is not accepted")
        if (name in tp and p.default is not P.empty
                and tp[name].default is P.empty):
            faults.append(f"{name!r} has a default in JAX, none in the port")
    var = [any(p.kind == P.VAR_POSITIONAL for p in ps.values())
           for ps in (jp, tp)]
    if var[0] != var[1]:
        faults.append("*args differ")
    for i, (name, p) in enumerate(tp.items()):
        stands_in = i < len(jpos) and jpos[i] in exempt
        if (name not in jp and p.default is P.empty and not stands_in
                and p.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD)):
            faults.append(f"the port's {name!r} is required")
    return faults


@pytest.mark.parametrize("rel,name", SIGNED,
                         ids=[f"{r}:{n}" for r, n in SIGNED])
def test_port_takes_jax_arguments(rel, name):
    """A public function or class of orca_tpu exists in the port (or is in
    EXEMPT_NAMES, and then does not) and takes JAX's arguments in JAX's
    positions, EXEMPT_PARAMS aside."""
    port = getattr(_module("orca_tpu_torch", rel), name, None)
    if (rel, name) in EXEMPT_NAMES:
        assert port is None
        return
    assert port is not None, f"{rel}: {name} has no counterpart"
    jax_obj = getattr(_module("orca_tpu", rel), name)
    assert _signature_faults(jax_obj, port,
                             EXEMPT_PARAMS.get((rel, name), {})) == []


EXEMPTIONS = sorted(
    [(rel, name, p) for (rel, name), ps in EXEMPT_PARAMS.items() for p in ps]
    + [(rel, name, None) for rel, name in EXEMPT_NAMES],
    key=lambda e: (e[0], e[1], e[2] or ""))


@pytest.mark.parametrize("rel,name,param", EXEMPTIONS,
                         ids=[f"{r}:{n}:{p}" for r, n, p in EXEMPTIONS])
def test_every_exemption_is_needed(rel, name, param):
    """Each exemption names a JAX function or class this check walks, and
    without it the check fails: the list cannot go stale."""
    assert (rel, name) in SIGNED
    if param is None:
        assert getattr(_module("orca_tpu_torch", rel), name, None) is None
        return
    exempt = dict(EXEMPT_PARAMS[(rel, name)])
    del exempt[param]
    assert _signature_faults(getattr(_module("orca_tpu", rel), name),
                             getattr(_module("orca_tpu_torch", rel), name),
                             exempt) != []


def test_orca_config_fifth_positional_raises():
    """JAX's fifth field is `encoder_block_bp`: passed positionally to the
    port's OrcaConfig it raises, and never sets the halo."""
    from orca_tpu_torch.utils.config import OrcaConfig

    with pytest.raises(TypeError):
        OrcaConfig("r", "m", "e", "float32", 800_000)
    cfg = OrcaConfig("r", "m", "e", "float32", encoder_halo_bp=116_000)
    assert (cfg.resource_dir, cfg.param_dtype, cfg.encoder_halo_bp) == (
        "r", "float32", 116_000)
