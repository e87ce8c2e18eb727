"""Cells at a tiny geometry for CPU tests: the configurations' published
widths, a window small enough for the CPU (the 32 Mb family at 512 kb with
4-bin crops, the 256 Mb family at 4.096 Mb), and traffic cut to match."""

import copy
import time

from portbench import harness

TINY = {
    "32m": {"window_bp": 512_000, "bin_bp": 4000, "crop": 4,
            "levels": [1, 2, 4, 8, 16, 32]},
    "256m": {"window_bp": 4_096_000, "bin_bp": 32000, "crop": 4,
             "levels": [32, 64, 128, 256]},
}
SEED = 2 ** 33 + 12345  # a seed wider than 32 bits, as the checks draw


def tiny_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    config["geometry"] = dict(TINY[config["family"]])
    return config


def tiny_traffic(traffic: dict, family: str) -> dict:
    t = copy.deepcopy(traffic)
    window = TINY[family]["window_bp"]
    t["pool_bp"] = 2 * window
    t["n_run_bp"] = [4000, 40000]
    t["check_requests"] = 1
    if "zoom_bp" in t:
        t["zoom_bp"] = window // 4
    if "chromosomes" in t:
        t["chromosomes"] = [["c1", 3_500_000], ["c2", 2_100_000]]
        t["background"] = {"finite_bins": 100, "total_bins": 160}
    return t


def tiny_spec(workload: str, **traffic_changes) -> dict:
    spec = copy.deepcopy(harness.cell_spec(harness.load_manifest(), workload))
    family = spec["config"]["family"]
    spec["config"] = tiny_config(spec["config"])
    spec["traffic"] = tiny_traffic(spec["traffic"], family)
    spec["traffic"].update(traffic_changes)
    return spec


def run_tiny(spec: dict, seed: int = SEED, traced: bool = False) -> dict:
    """One run on the CPU, past the harness's look for a card: one request
    in the window."""
    return harness.run_cell(spec, seed, 1e-3, traced, time.monotonic(),
                            device="cpu")
