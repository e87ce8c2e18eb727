"""The plain reference against the port, through whole runs of each cell
at a tiny geometry on the CPU (past the harness's look for a card); the
control, the reference in the precision below the cell's, in the
program's place; and runs with the timed path broken underneath, each of
which has to come out not correct."""

import numpy as np
import torch
import pytest

from portbench import control, harness
from portbench.drivers._cascade import CascadeDriver
from portbench_tiny import SEED, run_tiny, tiny_spec

CELLS = ["orca32m.bf16.screen", "orca256m.bf16.chrom", "orca32m.fp32.screen"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_correct_on_cpu(workload):
    result = run_tiny(tiny_spec(workload))
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["checks"]["coord_mismatch"]["value"] == 0


def test_traced_run_reports_its_metrics():
    result = run_tiny(tiny_spec("orca32m.fp32.screen"), traced=True)
    assert result["correct"]
    m = result["metrics"]
    # on the CPU no device operation is traced: the device's figures and
    # the tower's roofline are left out, the host spans are read
    assert {"input_ms.fp32", "decode_ms.fp32", "mfu.fp32"} <= set(m)
    assert "tower_roofline.fp32" not in m
    assert result["device"]["busy_s"] == 0.0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", ["orca32m.bf16.screen",
                                      "orca256m.bf16.chrom"])
def test_fp8_control_fails_the_bf16_limits(workload):
    """The bf16 cells' control: the reference with every convolution in
    float8 e4m3 (and the 256 Mb backgrounds averaged in bfloat16, one step
    below the program's float32) fails the limits of the maps and of the
    backgrounds."""
    line = control.calibrate(tiny_spec(workload), SEED, "cpu")
    assert line["program_correct"], line["program"]
    assert not line["control_correct"]
    failed = {name for name, c in line["control"].items()
              if c["value"] > c["limit"]}
    assert "map_rms_over_bf16" in failed
    assert "256" not in workload or "background_err" in failed


def test_traced_run_takes_the_counts_from_the_driver(monkeypatch):
    """A request kind that counts no FLOPs for its model fails a traced
    run, instead of reading another model's counts."""
    real = harness.load_driver

    def uncounted(traffic):
        class Driver(real(traffic)):
            request_flops = CascadeDriver.request_flops
        return Driver

    monkeypatch.setattr(harness, "load_driver", uncounted)
    with pytest.raises(NotImplementedError, match="counts no FLOPs"):
        run_tiny(tiny_spec("orca32m.fp32.screen"), traced=True)


def _patched(monkeypatch, name, wrap):
    from orca_tpu_torch.predict import multiscale
    monkeypatch.setattr(multiscale, name, wrap(getattr(multiscale, name)))


def _forward_rows_only(real):
    def run(pred):  # the reverse-complement half left out of the mean
        return pred[: pred.shape[0] // 2].float()
    return run


def _one_value_altered(real):
    def run(pred):
        out = real(pred).clone()
        out.view(-1)[out.numel() // 3] += 0.5 * out.abs().max()
        return out
    return run


def _start_shifted(real):
    def run(*args, **kwargs):
        index = real(*args, **kwargs)  # a crop of 4 bins: indices 0..2
        return torch.where(index < 2, index + 1, index - 1)
    return run


def _background_scaled(real):
    def run(normmat):
        return real(normmat) * np.float32(1.01)
    return run


FAULTS = [
    ("orca32m.fp32.screen", "_combine_orientations", _forward_rows_only),
    ("orca32m.fp32.screen", "_combine_orientations", _one_value_altered),
    ("orca32m.fp32.screen", "_zoom_start_index", _start_shifted),
    ("orca256m.bf16.chrom", "_combine_orientations", _forward_rows_only),
    ("orca256m.bf16.chrom", "_combine_orientations", _one_value_altered),
    ("orca256m.bf16.chrom", "_zoom_start_index_256", _start_shifted),
    ("orca256m.bf16.chrom", "_filled_background", _background_scaled),
]


@pytest.mark.parametrize("workload,name,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, _, f in FAULTS])
def test_broken_program_is_not_correct(monkeypatch, workload, name, fault):
    _patched(monkeypatch, name, fault)
    result = run_tiny(tiny_spec(workload, precision="float32"))
    assert not result["correct"], result["checks"]
