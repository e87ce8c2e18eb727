"""The port's loader benchmark (orca_tpu_torch/scripts/measure_loader.py)
against the JAX package's scripts/measure_loader.py: from the same sampler
construction and seed, the prefetch loader's first batches (thread backend,
one worker, so their order is fixed) are bit-equal to the JAX package's
loader's, packed and float32; `main` at a 400 kb window, in a process of
its own, prints the JAX script's keys plus the card's fields."""

import ast
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from orca_tpu.data.pipeline import PrefetchLoader as JaxPrefetchLoader
from orca_tpu_torch.data.pipeline import PrefetchLoader
from orca_tpu_torch.scripts import measure_loader

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "measure_loader.py"
WINDOW = 400_000


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_measure_loader",
                                                  JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _first_batches(loader_cls, sampler, n=3):
    with loader_cls(sampler, 1, num_workers=1, backend="thread") as loader:
        return [loader.get(timeout=60) for _ in range(n)]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float32"])
def test_first_batches_bit_equal_to_jax(packed):
    want = _first_batches(JaxPrefetchLoader, _jax_script().make_sampler(
        WINDOW, 4000, packed))
    got = _first_batches(PrefetchLoader, measure_loader.make_sampler(
        WINDOW, 4000, packed))
    for g, w in zip(got, want, strict=True):
        assert len(g) == len(w)
        for a, b in zip(g, w, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    seq = got[0][0]
    assert seq.shape[:2] == (1, WINDOW)
    assert seq.dtype == (np.uint8 if packed else np.float32)


def _jax_line_keys():
    tree = ast.parse(JAX_SCRIPT.read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric"
                        for k in n.keys))
    return {k.value for k in node.keys}


def test_main_prints_the_jax_keys():
    """`main` in a fresh process, as a training run's loader starts (its
    worker processes fork, and this test process runs JAX's threads)."""
    env = dict(os.environ, ORCA_LOADER_WINDOW=str(WINDOW))
    env.pop("PYTHONPATH", None)
    code = ("from orca_tpu_torch.scripts import measure_loader\n"
            "measure_loader.main(n_batches=2, device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.splitlines()[-1])
    assert set(line) == _jax_line_keys() | {"device", "power_limit_w"}
    assert line["window_bp"] == WINDOW and line["workers"] == 2
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    for key in ("packed_uint8", "float32", "packed_batch_mb",
                "float32_batch_mb", "speedup"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    assert line["float32_batch_mb"] > line["packed_batch_mb"]
