"""Sustained variant-screen benchmark through the warm server (counterpart
of the JAX package's scripts/bench_serve_screen.py).

The reference's stated scale-out use case is "more than a couple dozen
variants" (reference README.md:236); the number an operator plans capacity
with is the amortized per-variant time once the process is warm. This
starts ONE `python -m orca_tpu_torch.cli serve --prewarm 32M` process
(each model's first request paid before READY), runs a warm-up region and
N dup/del screens in the production configuration (both H1-ESC and HFF
models per command, bf16 serving precision, plots and .pkl outputs), and
prints one JSON line: the JAX script's keys, `serve_plots` (which plot mode
ran) and the card's name and power limit. Numbers are not rounded.

Self-contained: it writes the model dir (two random folded bundles pickled
by `zoo.save_bundle`, the `convert` output format) and a code-memmap genome
of two 34 Mb chromosomes. This process never opens CUDA (the card's name and
limit come from nvidia-smi), so the server alone holds the card; the server
is torn down on any exit of this process, `timeout`'s SIGTERM included.

Plots: `--plots pdf` (the default) draws every PDF with matplotlib and fails
before the server starts when matplotlib is not importable. `--plots record`
starts the server through this module's own entry, which replaces
`viz.genomeplot` and `viz.genomeplot_256mb` with a recorder that appends
each file name to `<root>/out/recorded_plots.txt`, then runs
`cli.main(["serve", ...])`. Each command's `orca_pred.pkl` is renamed to
`<index>_<mode>.pkl` after its OK (index 0 is the warm-up region), so every
output survives the screen.

    python -m orca_tpu_torch.scripts.bench_serve_screen [N] [--json PATH]
        [--plots pdf|record] [--root DIR]

N defaults to 10. `--root` keeps the fixture and the outputs in DIR;
without it they go to a temporary directory that is removed at the end.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from orca_tpu_torch.scripts._common import require_matplotlib, smi_card_fields
from orca_tpu_torch.utils.config import REPO_ROOT, resolve_device

GENOME_STEM = "Homo_sapiens.GRCh38.dna.primary_assembly"
CHROM_BP = 34_000_000
RECORDED_PLOTS = "recorded_plots.txt"
_RECORD_ENTRY = "--serve-recording-plots"
MODULE = "orca_tpu_torch.scripts.bench_serve_screen"


def build_fixture(root):
    """Model dir (2 bundle pickles) + resource dir (codes memmap), built on
    the CPU."""
    from orca_tpu_torch.models import zoo

    model_dir = os.path.join(root, "models")
    resource_dir = os.path.join(root, "resources")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(resource_dir, exist_ok=True)

    for seed, name in ((0, "h1esc"), (1, "hff")):
        bundle = zoo.fold_bundle(zoo.random_32m_bundle(seed=seed, device="cpu"))
        zoo.save_bundle(bundle, os.path.join(model_dir, f"orca_{name}.bundle"))

    rng = np.random.RandomState(0)
    mm_path = os.path.join(resource_dir, f"{GENOME_STEM}.codes.mmap")
    n8, n9 = CHROM_BP, CHROM_BP
    mm = np.memmap(mm_path, dtype=np.uint8, mode="w+", shape=(n8 + n9,))
    mm[:n8] = rng.randint(0, 4, n8).astype(np.uint8)
    mm[n8:] = rng.randint(0, 4, n9).astype(np.uint8)
    mm.flush()
    del mm
    with open(mm_path + ".json", "w") as f:
        json.dump({"chroms": [["chr8", 0, n8], ["chr9", n8, n8 + n9]]}, f)
    return model_dir, resource_dir


def warmup_command(out):
    """The first command: a 200 kb region, everything already warm."""
    return f"region chr8:16900000-17100000 {out} --no-target"


def screen_commands(n_variants, out):
    """The sustained screen: alternating dup/del at shifting coordinates;
    every command runs full cascades (fwd+RC, 2 models) on new sequence."""
    cmds = []
    for i in range(n_variants):
        mode = "dup" if i % 2 == 0 else "del"
        chrom = "chr8" if i % 4 < 2 else "chr9"
        start = 16_500_000 + i * 50_000
        end = start + 500_000
        cmds.append(f"{mode} {chrom}:{start}-{end} {out} --no-target")
    return cmds


def server_argv(model_dir, resource_dir, plots, out):
    """The server's command line: `cli serve --prewarm 32M`, through this
    module's recording entry under `--plots record`."""
    serve = ["serve", "--model-dir", model_dir, "--resource-dir", resource_dir,
             "--prewarm", "32M"]
    if plots == "record":
        return [sys.executable, "-m", MODULE, _RECORD_ENTRY,
                os.path.join(out, RECORDED_PLOTS)] + serve
    return [sys.executable, "-m", "orca_tpu_torch.cli"] + serve


def run_screen(argv, env, out, n_variants, cwd=None):
    """Start the server `argv`, wait for READY, send the warm-up command and
    the screen, then `quit`. Returns (ready_s, the WARM lines, first command
    s, screen s, the kept .pkl paths). The server is terminated on any exit
    (an exception, this process's exit or SIGTERM)."""
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, env=env,
                            cwd=cwd)

    # A surviving server holds the card and slows the next run, so tear it
    # down on ANY exit of this process, `timeout`'s SIGTERM included.
    def _cleanup(*_a):
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if _a:  # invoked as a signal handler
            sys.exit(143)

    atexit.register(_cleanup)
    previous = signal.signal(signal.SIGTERM, _cleanup)

    def send(line):
        proc.stdin.write(line + "\n")
        proc.stdin.flush()

    warm_lines = []

    def wait_for(tokens=("OK", "ERR", "READY")):
        while True:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError("server exited early")
            line = line.strip()
            if line.startswith("WARM"):
                warm_lines.append(line)
            if any(line.startswith(t) for t in tokens):
                return line

    pkls = []

    def keep_pkl(mode):
        path = os.path.join(out, f"{len(pkls):03d}_{mode}.pkl")
        os.replace(os.path.join(out, "orca_pred.pkl"), path)
        pkls.append(path)

    try:
        # --prewarm runs each model's first request BEFORE READY, so ready_s
        # is the full time-to-service (load + warm-up)
        t0 = time.perf_counter()
        line = wait_for(("READY",))
        if line != "READY":
            raise RuntimeError(f"server said {line!r} before READY")
        ready_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        send(warmup_command(out))
        line = wait_for()
        if line != "OK":
            raise RuntimeError(f"warm-up command: {line}")
        first_s = time.perf_counter() - t0
        keep_pkl("region")

        cmds = screen_commands(n_variants, out)
        t0 = time.perf_counter()
        for c in cmds:
            send(c)
            line = wait_for()
            if line != "OK":
                raise RuntimeError(f"{c!r}: {line}")
            keep_pkl(c.split()[0])
        screen_s = time.perf_counter() - t0
        send("quit")
        proc.wait(timeout=60)
    finally:
        _cleanup()
        atexit.unregister(_cleanup)
        signal.signal(signal.SIGTERM, previous)
    return ready_s, warm_lines, first_s, screen_s, pkls


def main(n_variants=10, json_path=None, plots="pdf", root=None, device=None,
         argv_fn=server_argv) -> dict:
    """Build the fixture, run the screen through one server and print the
    JSON line; returns it. `device` None means the CUDA card (raises without
    it); "cpu" is for tests, whose `argv_fn` starts a stand-in server."""
    device = resolve_device(device)
    if plots not in ("pdf", "record"):
        raise ValueError(f"--plots {plots!r}: pdf or record")
    if plots == "pdf":
        require_matplotlib("bench_serve_screen")
    card = (smi_card_fields() if device.type == "cuda"
            else {"device": str(device), "power_limit_w": None})

    keep = root is not None
    root = root or tempfile.mkdtemp(prefix="orca_serve_screen_")
    try:
        out = os.path.join(root, "out")
        os.makedirs(out, exist_ok=True)
        model_dir, resource_dir = build_fixture(root)

        env = dict(os.environ)
        env["ORCA_TPU_PARAM_DTYPE"] = "bfloat16"  # production serving config
        ready_s, warm_lines, first_s, screen_s, _ = run_screen(
            argv_fn(model_dir, resource_dir, plots, out), env, out,
            n_variants, cwd=str(REPO_ROOT))
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)

    prewarm_s = None
    if warm_lines:  # "WARM 32M 61.2s"
        try:
            prewarm_s = float(warm_lines[0].split()[-1].rstrip("s"))
        except ValueError:
            pass
    fields = {
        "serve_ready_s": ready_s,
        "serve_prewarm_s": prewarm_s,
        "serve_first_command_s": first_s,
        "serve_n_variants": n_variants,
        "serve_seconds_per_variant": screen_s / n_variants,
        "serve_dtype": "bfloat16",
        "serve_models_per_command": 2,
        "serve_plots": plots,
        **card,
    }
    print(json.dumps(fields), flush=True)
    if json_path:
        from orca_tpu_torch.scripts.smoke_e2e import merge_json

        merge_json(json_path, fields)
    return fields


def serve_recording_plots(record_path, argv) -> int:
    """`cli.main(argv)` with the two drawing functions replaced by a
    recorder that appends each plot's file name to `record_path`."""
    from orca_tpu_torch import cli, viz

    def record(output, file=None, **kw):
        with open(record_path, "a") as f:
            f.write(f"{file}\n")

    viz.genomeplot = viz.genomeplot_256mb = record
    return cli.main(argv)


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m orca_tpu_torch.scripts.bench_serve_screen",
        description="seconds per variant of a dup/del screen through one "
                    "warm server on the CUDA card")
    p.add_argument("n_variants", nargs="?", type=int, default=10)
    p.add_argument("--json", dest="json_path", default=None,
                   help="merge the fields into this JSON file")
    p.add_argument("--plots", choices=["pdf", "record"], default="pdf",
                   help="pdf: draw every plot (needs matplotlib); record: "
                        "record the plots' file names instead")
    p.add_argument("--root", default=None,
                   help="keep the fixture and outputs here")
    return p.parse_args(argv)


if __name__ == "__main__":
    if sys.argv[1:2] == [_RECORD_ENTRY]:
        sys.exit(serve_recording_plots(sys.argv[2], sys.argv[3:]))
    a = _parse(sys.argv[1:])
    main(a.n_variants, json_path=a.json_path, plots=a.plots, root=a.root)
