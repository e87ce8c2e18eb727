"""Benchmark of the port on the CUDA card (counterpart of the repository's
root bench.py): Mb of sequence per second per card through the 32 Mb
multiscale cascade (fwd + reverse complement in one batch, six decoded
levels) of a random full-width H1-ESC-architecture bundle, printed as ONE
JSON line with the JAX benchmark's keys plus `power_limit_w`.

    python -m orca_tpu_torch.cli bench

Sections, in order, each on the card: the headline dtype (bf16, the serving
precision; ORCA_BENCH_DTYPE sets another), two models one after the other,
fp32 (TF32 off) and its two-model run (ORCA_BENCH_SKIP_FP32=1 skips both),
the 256 Mb whole-chromosome cascade in bf16 and fp32
(ORCA_BENCH_SKIP_256M=1), and stage-a and stage-b training steps from
`bench_training` (ORCA_BENCH_SKIP_TRAIN=1). ORCA_BENCH_ITERS (default 3)
sets the timed runs. A failed 256 Mb or training section is reported under
`bench_256m_error` / `bench_train_error`, as the JAX benchmark does.

The timed window is the cascade alone: the packed (1, L, 4) uint8 sequence
is put on the card before timing, and each run ends in a host fetch of the
last level's sum. Unlike a `genomepredict` request, the figures therefore
exclude the host's packing and the copy of the sequence to the card.
`compile_s` is the time to the first prediction: the warm-up request
(`warmup_cascade_32m`) plus one run. Torch compiles nothing, so it holds the
kernel library's load, cuDNN's plan choice and the allocator's pools, and
the kernels' nvcc build when none is cached. `channel_setup_s` is the CUDA
context's creation plus the first device-to-host fetch. Numbers are not
rounded. Each section's seconds and peak device memory go to stderr; stdout
holds the JSON line alone.

The baseline fields are the JAX benchmark's: `vs_baseline` divides by a
design estimate of the cascade on an A100 in fp32 torch (2.0 Mb/s), and
`torch_cpu_mb_per_s` is read from the repository's BASELINE_TORCH.json when
it is there.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from orca_tpu_torch.bench_training import bench_stage_a, bench_stage_b
from orca_tpu_torch.models import zoo
from orca_tpu_torch.predict import retrieval
from orca_tpu_torch.predict.multiscale import (
    GEOM_32M,
    GEOM_256M,
    CascadeGeometry,
    _cascade_32mb,
    _cascade_256mb,
    warmup_cascade_32m,
    warmup_cascade_256m,
)
from orca_tpu_torch.utils.config import REPO_ROOT, resolve_device

A100_BASELINE_MB_PER_S = 2.0  # design estimate; see BASELINE_TORCH.json
# the 256 Mb request: a chr8-sized first chromosome padded to the window
CHROM_BP = 145_100_000


def _load_torch_baseline():
    path = REPO_ROOT / "BASELINE_TORCH.json"
    if path.exists():
        return json.loads(path.read_text())
    return None


def _packed_window(window_bp: int, device) -> torch.Tensor:
    """The benchmark's sequence: RandomState(0) codes as the packed
    quarter-scale uint8 one-hot, (1, window_bp, 4) on `device`."""
    codes = np.random.RandomState(0).randint(0, 4, size=window_bp)
    return torch.from_numpy((np.eye(4, dtype=np.uint8) * 4)[codes][None]).to(
        device)


def _bundles(dtype: str, seeds, geometry: CascadeGeometry, device):
    return [
        zoo.cast_bundle(zoo.fold_bundle(zoo.random_32m_bundle(
            seed=s, device=device, nbins=geometry.bins, crop=geometry.crop,
        )), dtype)
        for s in seeds
    ]


def _run_32m(bundles, geometry: CascadeGeometry, seq: torch.Tensor, mpos,
             wpos, log_normmats):
    """One timed run: each bundle's cascade in turn (the predict loop runs
    its models one after another), each forced by a host fetch of its last
    level's sum. Returns (the sums' total, the last cascade's (preds,
    starts))."""
    total = 0.0
    with torch.inference_mode():
        for bundle in bundles:
            out = _cascade_32mb(bundle, geometry, seq, mpos, wpos,
                                log_normmats)
            total += float(out[0][-1].float().sum())
    return total, out


def _measure(dtype: str, seq: torch.Tensor, mpos, wpos, iters: int,
             n_models: int = 1, geometry: CascadeGeometry = GEOM_32M,
             device=None):
    """(seconds a run, seconds to the first prediction) of `n_models` random
    bundles' cascades on `seq`, at `geometry`, on `device` (None = CUDA)."""
    device = resolve_device(device)
    bundles = _bundles(dtype, range(n_models), geometry, device)
    log_normmats = bundles[0].log_normmats()

    def run():
        return _run_32m(bundles, geometry, seq, mpos, wpos, log_normmats)

    t0 = time.perf_counter()
    warmup_cascade_32m(bundles[0], geometry, n=1, device=device)
    run()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters, compile_s


def _chrlen(geometry: CascadeGeometry) -> int:
    """The first chromosome's length: 145.1 Mb of a 256 Mb window, scaled
    with the window, in whole bins."""
    bp = geometry.window_bp * CHROM_BP // GEOM_256M.window_bp
    return bp - bp % geometry.bin_bp


def _background_256m(bundle, geometry: CascadeGeometry) -> np.ndarray:
    """The region mosaic's background (`retrieval.assemble_normmat`) of the
    first chromosome and its padding, NaNs set to the least value."""
    chrlen = _chrlen(geometry)
    regions = [["chrM", 0, chrlen, "+"],
               ["chrP", 0, geometry.window_bp - chrlen, "+"]]
    normmat = retrieval.assemble_normmat(
        regions, bundle.background_cis, bundle.background_trans,
        binsize=geometry.bin_bp,
    ).astype(np.float32)
    mask = np.isnan(normmat)
    if mask.any():
        normmat[mask] = np.nanmin(normmat[~mask])
    return normmat


def _run_256m(bundle, geometry: CascadeGeometry, seq: torch.Tensor,
              normmat: torch.Tensor):
    """One timed 256 Mb run, zoomed at a quarter of the window, forced by a
    host fetch of the last level's sum. Returns (the sum, (preds, starts,
    backgrounds))."""
    with torch.inference_mode():
        out = _cascade_256mb(bundle, geometry, seq, geometry.window_bp / 4,
                             geometry.window_bp / 2, _chrlen(geometry),
                             normmat)
        return float(out[0][-1].float().sum()), out


def _measure_256m(dtype: str, iters: int,
                  geometry: CascadeGeometry = GEOM_256M, device=None):
    """One whole-chromosome cascade (a chr8-sized chromosome and a padding
    one, the mosaic's background, fwd + RC, 4 levels): (seconds a run,
    seconds to the first prediction), on `device` (None = CUDA)."""
    device = resolve_device(device)
    bundle = zoo.cast_bundle(zoo.fold_256m_bundle(
        zoo.random_256m_bundle(seed=0, device=device)), dtype)
    normmat = torch.from_numpy(_background_256m(bundle, geometry)).to(device)
    seq = _packed_window(geometry.window_bp, device)

    def run():
        return _run_256m(bundle, geometry, seq, normmat)

    t0 = time.perf_counter()
    warmup_cascade_256m(bundle, geometry, n=1, device=device)
    run()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters, compile_s


def _power_limit_w(device: torch.device):
    """The card's power limit in W as nvidia-smi prints it; None off the
    card, or where nvidia-smi cannot say."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@contextlib.contextmanager
def _section(name: str, device: torch.device):
    """Print the section's seconds and, on the card, its peak device memory
    to stderr; the allocator's cache is emptied before it starts."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        line = f"bench section {name}: {time.perf_counter() - t0:.3f} s"
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            line += f", peak device memory {peak:.2f} GiB"
        print(line, file=sys.stderr, flush=True)


def main(geometry: CascadeGeometry = GEOM_32M,
         geometry_256m: CascadeGeometry = GEOM_256M, device="cuda") -> dict:
    """Run every section not skipped and print the JSON line; returns it.
    The geometries and the device are production and the card; tests run
    them small on the CPU."""
    device = resolve_device(device)
    dtype = os.environ.get("ORCA_BENCH_DTYPE", "bfloat16")
    iters = int(os.environ.get("ORCA_BENCH_ITERS", "3"))
    skip_fp32 = dtype == "float32" or os.environ.get("ORCA_BENCH_SKIP_FP32")
    window_mb = geometry.window_bp / 1e6

    # CUDA context creation and the first device-to-host fetch, timed apart
    t0 = time.perf_counter()
    torch.zeros(1, device=device).cpu()
    channel_setup_s = time.perf_counter() - t0

    seq = _packed_window(geometry.window_bp, device)
    mpos = wpos = geometry.window_bp / 2
    with _section(f"32Mb {dtype}", device):
        dt, compile_s = _measure(dtype, seq, mpos, wpos, iters,
                                 geometry=geometry, device=device)
    mb_per_s = window_mb / dt
    result = {
        "metric": "Mb_sequence_per_s_per_chip_32Mb_multiscale",
        "value": mb_per_s,
        "unit": "Mb/s/chip",
        "vs_baseline": mb_per_s / A100_BASELINE_MB_PER_S,
        "baseline_basis": "A100 design estimate 2.0 Mb/s (fp32 torch)",
        "seconds_per_32Mb_window": dt,
        "compile_s": compile_s,
        "channel_setup_s": channel_setup_s,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "power_limit_w": _power_limit_w(device),
        "dtype": dtype,
    }
    torch_baseline = _load_torch_baseline()
    if torch_baseline:
        result["torch_cpu_mb_per_s"] = torch_baseline["mb_per_s"]
        result["vs_torch_cpu"] = mb_per_s / torch_baseline["mb_per_s"]

    # the standard two-model (H1-ESC + HFF) predict: models in turn
    with _section(f"32Mb {dtype} two models", device):
        dt2, _ = _measure(dtype, seq, mpos, wpos, max(1, iters - 1),
                          n_models=2, geometry=geometry, device=device)
    result["two_model_mb_per_s"] = window_mb / dt2
    result["two_model_seconds_per_window"] = dt2

    if not skip_fp32:
        with _section("32Mb float32", device):
            dt32, compile32 = _measure("float32", seq, mpos, wpos,
                                       max(1, iters - 1), geometry=geometry,
                                       device=device)
        result["fp32_mb_per_s"] = window_mb / dt32
        result["fp32_seconds_per_window"] = dt32
        result["fp32_compile_s"] = compile32
        with _section("32Mb float32 two models", device):
            dt32_2, _ = _measure("float32", seq, mpos, wpos, 1, n_models=2,
                                 geometry=geometry, device=device)
        result["fp32_two_model_mb_per_s"] = window_mb / dt32_2
    del seq

    mb_256 = geometry_256m.window_bp / 1e6
    if not os.environ.get("ORCA_BENCH_SKIP_256M"):
        try:
            with _section(f"256Mb {dtype}", device):
                dt256, compile256 = _measure_256m(
                    dtype, max(1, iters - 1), geometry_256m, device)
            result["mb_per_s_256m"] = mb_256 / dt256
            result["seconds_per_256Mb_window"] = dt256
            result["compile_s_256m"] = compile256
            if not skip_fp32:
                with _section("256Mb float32", device):
                    dt256_32, _ = _measure_256m("float32", 1, geometry_256m,
                                                device)
                result["fp32_mb_per_s_256m"] = mb_256 / dt256_32
        except Exception as e:  # noqa: BLE001 — never lose the headline
            traceback.print_exc()
            result["bench_256m_error"] = f"{type(e).__name__}: {e}"

    # training steps at production geometry (stage b's frozen tower runs the
    # fused kernels; stage a trains the whole 1 Mb Net on cuDNN)
    if not os.environ.get("ORCA_BENCH_SKIP_TRAIN"):
        try:
            with _section("train stage a", device):
                result.update(bench_stage_a(iters=3, device=device))
            with _section("train stage b", device):
                result.update(bench_stage_b(iters=2, device=device))
        except Exception as e:  # noqa: BLE001 — never lose the headline
            traceback.print_exc()
            result["bench_train_error"] = f"{type(e).__name__}: {e}"

    print(json.dumps(result), flush=True)
    return result
