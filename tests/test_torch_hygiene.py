"""The port stands alone: orca_tpu_torch, chip_smoke.py and the port's card
scripts import neither JAX nor anything of orca_tpu, and the port's entry
points run on CUDA unless the caller asks for the CPU."""

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
        multiscale.genomepredict(None, "chr1", models=())
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.load_bundle("unused.bundle")
