"""Checks of `BENCHMARK.json` against the benchmark's contract and against
the files the harness finds by name: `validate` returns the problems it
finds (none for a sound manifest)."""

from __future__ import annotations

import json
import pathlib
import re
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def validate(manifest: dict, root: pathlib.Path) -> List[str]:
    bad: List[str] = []
    here = root / "portbench"
    if set(manifest) != KEYS:
        bad.append(f"top-level keys {sorted(manifest)}")
    cmd = manifest["command"]
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        bad.append("command")
    if not 1 <= manifest["run_seconds"] <= 51:
        bad.append("run_seconds")
    configs = {c["name"]: c for c in manifest["configs"]}
    cells = {w["name"]: w for w in manifest["workloads"]}
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = list(configs) + list(cells) + [m["name"] for m in metrics]
    for n in names:
        if not NAME.match(n):
            bad.append(f"name {n!r}")
    for group in (configs, cells, [m["name"] for m in metrics]):
        if len(group) != len(set(group)):
            bad.append("duplicate names")
    for c in manifest["configs"]:
        if set(c) != CONFIG_KEYS or not _line(c["why"]):
            bad.append(f"config {c['name']}: keys or why")
        if not (root / c["file"]).is_file():
            bad.append(f"config {c['name']}: no file {c['file']}")
        else:
            data = json.loads((root / c["file"]).read_text())
            if sorted(data.get("reduced", [])) != sorted(c["reduced"]):
                bad.append(f"config {c['name']}: reduced differs from file")
        if not any(w["config"] == c["name"] for w in cells.values()):
            bad.append(f"config {c['name']}: no cell")
    pairs = set()
    for w in cells.values():
        if set(w) != CELL_KEYS or not _line(w["why"]):
            bad.append(f"cell {w['name']}: keys or why")
        if w["chips"] not in (1, 4):
            bad.append(f"cell {w['name']}: chips")
        if w["config"] not in configs:
            bad.append(f"cell {w['name']}: unknown config")
        if (w["config"], w["traffic"]) in pairs:
            bad.append(f"cell {w['name']}: repeats a config and traffic")
        pairs.add((w["config"], w["traffic"]))
        traffic = here / "traffic" / f"{w['traffic']}.json"
        if not traffic.is_file():
            bad.append(f"cell {w['name']}: no traffic file")
        else:
            driver = json.loads(traffic.read_text())["driver"]
            if not (here / "drivers" / f"{driver}.py").is_file():
                bad.append(f"cell {w['name']}: no driver {driver}")

    def cells_of(m):
        return m.get("workloads", list(cells))

    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in metrics:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                            "higher"):
            bad.append(f"metric {m['name']}: unit or better")
        for w in m.get("workloads", []):
            if w not in cells:
                bad.append(f"metric {m['name']}: unknown cell {w}")
    for m in manifest["end_to_end"]:
        if set(m) - {"workloads"} != E2E_KEYS or m["source"] not in E2E_SOURCES:
            bad.append(f"end-to-end {m['name']}: keys or source")
        if not 0.01 <= m["bound"] <= 0.25:
            bad.append(f"end-to-end {m['name']}: bound")
    for m in manifest["per_layer"]:
        if set(m) - {"workloads"} != LAYER_KEYS or m["source"] not in SOURCES \
                or not _line(m["layer"]):
            bad.append(f"per-layer {m['name']}: keys, source or layer")
        if m["moves"] not in e2e:
            bad.append(f"per-layer {m['name']}: moves {m['moves']}")
        elif not set(cells_of(m)) <= set(cells_of(e2e[m["moves"]])):
            bad.append(f"per-layer {m['name']}: a cell lacks {m['moves']}")
        quantity = m["name"].split(".", 1)[0]
        if not any((here / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], quantity)):
            bad.append(f"per-layer {m['name']}: no reader")
        if ("mfu" in quantity or quantity.endswith("_roofline")) \
                and m["unit"] != "%":
            bad.append(f"per-layer {m['name']}: a share of a roofline or a peak is in %")
    for w in cells:
        mine = [m["name"] for m in manifest["end_to_end"]
                if w in cells_of(m)]
        if "setup_s" not in mine or len(mine) < 2:
            bad.append(f"cell {w}: end-to-end metrics {mine}")
        if not any(w in cells_of(m) for m in manifest["per_layer"]):
            bad.append(f"cell {w}: no per-layer metric")
    return bad
