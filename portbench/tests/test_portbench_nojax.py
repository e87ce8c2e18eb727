"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Checked in fresh processes, with
top-level module names compared whole."""

import ast
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "from portbench.harness import forbidden_modules\n"
         "print(','.join(forbidden_modules()))\n"
         "print('orca_tpu_torch' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    found, torch_port = out.stdout.splitlines()[-2:]
    return [f for f in found.split(",") if f], torch_port == "True"


def test_the_port_and_the_harness_pass():
    found, port = _loaded(
        "import portbench.run, portbench.harness\n"
        "import portbench.drivers.predict32m, portbench.drivers.predict256m\n"
        "from orca_tpu_torch.predict import multiscale\n"
        "from orca_tpu_torch.models import convert, zoo")
    assert port and found == []


def test_the_jax_package_fails():
    found, _ = _loaded("import orca_tpu.utils.config")
    assert "orca_tpu" in found and all(
        f.split(".")[0] == "orca_tpu" for f in found)


def test_reference_loads_nothing_of_the_program():
    found, port = _loaded("import portbench.reference.orca, "
                          "portbench.compare, portbench.weights, "
                          "portbench.inputs, portbench.flops")
    assert not port and found == []


def test_reference_sources_import_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("orca_tpu", "orca_tpu_torch",
                                               "jax", "jaxlib", "flax"), \
                    (path, n)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "orca32m.bf16.screen", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(ROOT)})
    assert out.returncode != 0 and out.stdout.strip() == ""
