"""The port stands alone: orca_tpu_torch, chip_smoke.py and the port's card
scripts import neither JAX nor anything of orca_tpu, the port's entry points
(load_resources and the process_* pipelines included) run on CUDA unless the
caller asks for the CPU, the prediction API and the plots import without
matplotlib, and a 256 Mb bundle pickled by the JAX package loads into the
port's class without it."""

import ast
import os
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
