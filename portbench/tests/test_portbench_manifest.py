"""BENCHMARK.json against the contract and the files the harness finds by
name, and a new cell added with data files alone."""

import json
import pathlib
import shutil
import subprocess
import sys

from portbench import harness
from portbench.manifest import validate
from portbench_tiny import SEED, tiny_config, tiny_traffic

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_is_sound():
    assert validate(_manifest(), ROOT) == []


def test_validate_finds_faults():
    m = _manifest()
    m["per_layer"][0]["moves"] = "request_s_p90"  # not in every cell
    m["workloads"][0]["name"] = "bad name"
    m["end_to_end"][0]["unit"] = "Mb per s"
    bad = validate(m, ROOT)
    assert any("moves" in b or "lacks" in b for b in bad)
    assert any("bad name" in b for b in bad)
    assert any("unit" in b for b in bad)


def test_every_cell_resolves():
    m = _manifest()
    for w in m["workloads"]:
        spec = harness.cell_spec(m, w["name"])
        assert harness.load_driver(spec["traffic"]).family == \
            spec["config"]["family"]
        assert {harness.quantity(x["name"]) for x in spec["end_to_end"]} \
            >= {"setup_s", "mb_per_s"}
        for metric in spec["per_layer"]:
            assert hasattr(harness._load_file("metrics", metric["name"]),
                           "read")


def test_new_cell_from_data_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration file, a traffic file
    and a manifest entry, no code, and a run of the new cell on the CPU
    comes out correct."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = _manifest()
    config = tiny_config(json.loads(
        (ROOT / "portbench/configs/orca-h1esc-hff-32m.json").read_text()))
    config["name"] = "orca-tiny-32m"
    config["models_per_request"] = 1
    traffic = tiny_traffic(json.loads(
        (ROOT / "portbench/traffic/screen32m_fp32.json").read_text()), "32m")
    (tmp_path / "portbench/configs/orca-tiny-32m.json").write_text(
        json.dumps(config))
    (tmp_path / "portbench/traffic/tiny_fp32.json").write_text(
        json.dumps(traffic))
    m["configs"].append({"name": "orca-tiny-32m", "source": "a test",
                         "file": "portbench/configs/orca-tiny-32m.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny.fp32", "config": "orca-tiny-32m",
                           "traffic": "tiny_fp32", "chips": 1,
                           "why": "a test"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric["name"].endswith(".fp32"):
            metric["workloads"].append("tiny.fp32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    assert validate(m, tmp_path) == []
    code = (
        "import json, time, sys\n"
        f"sys.path.insert(1, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "spec = harness.cell_spec(harness.load_manifest(), 'tiny.fp32')\n"
        "for traced in (False, True):\n"
        f"    r = harness.run_cell(spec, {SEED}, 1e-3, traced,"
        " time.monotonic(), device='cpu')\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = (json.loads(line) for line
                        in out.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and traced["correct"], out.stdout
    assert set(untraced["metrics"]) == {"mb_per_s.fp32", "peak_device_gib",
                                        "setup_s"}
    # on the CPU the traced run reads the host spans and the FLOPs that
    # the request kind counts for the new configuration's one model
    assert {"mfu.fp32", "input_ms.fp32", "decode_ms.fp32"} <= set(
        traced["metrics"])
    assert list(untraced)[-1] == list(traced)[-1] == "checks"
