"""On a card: a short run of each cell through the command, correct, with
the contract's keys; and each cell's control failing its limits where the
program passes them. Marked `gpu`: each skips without a card."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["orca32m.bf16.screen",
                                      "orca256m.bf16.chrom",
                                      "orca32m.fp32.screen"])
def test_short_run_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2 ** 33 + 3), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["orca32m.bf16.screen",
                                      "orca256m.bf16.chrom",
                                      "orca32m.fp32.screen"])
def test_control_fails_on_the_card(card, workload):
    """At the cell's own size: the program's answers pass the limits and
    the control's (float8 e4m3 for bf16, TF32 for fp32) fail them."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload", workload,
         "--seeds", str(2 ** 33 + 5)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["program_correct"] and not line["control_correct"], line
