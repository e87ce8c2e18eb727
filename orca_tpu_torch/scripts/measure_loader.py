"""Measure PrefetchLoader throughput: packed uint8 vs float32 wire format
(counterpart of the JAX package's scripts/measure_loader.py).

The training input pipeline's sampler can emit packed quarter-scale uint8
sequences (16x smaller through the worker queues). This measures delivered
batches/s for both formats on a stage-b-like geometry (32 Mb windows scaled
down to ORCA_LOADER_WINDOW bp, default 4 Mb, to fit the host) with two
worker processes, and prints one JSON line with the JAX script's keys plus
the card's name and power limit, read after the workers are gone. Host work
only: no kernel is launched, and the workers (forked) never touch CUDA.
Numbers are not rounded.

    python -m orca_tpu_torch.scripts.measure_loader [--batches N]

N (default 24) is the timed batches per format, after one warm batch.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from orca_tpu_torch.data import genome as g
from orca_tpu_torch.data.pipeline import PrefetchLoader
from orca_tpu_torch.data.sampler import RandomWindowSampler
from orca_tpu_torch.data.targets import DenseContactMatrix
from orca_tpu_torch.scripts._common import card_fields
from orca_tpu_torch.utils.config import resolve_device


def make_sampler(window_bp, res, packed, seed=0):
    rng = np.random.RandomState(seed)
    chrlen = 2 * window_bp
    gen = g.CodeGenome({
        "chr1": rng.randint(0, 4, chrlen).astype(np.uint8),
        "chr2": rng.randint(0, 4, chrlen).astype(np.uint8),
    })
    nb = chrlen // res
    mats = {c: np.abs(rng.rand(nb, nb)).astype(np.float32)
            for c, _ in gen.get_chr_lens()}
    target = DenseContactMatrix(mats, resolution=res,
                                shape=(window_bp // res, window_bp // res))
    return RandomWindowSampler(
        gen, target, sequence_length=window_bp, position_resolution=res,
        random_strand=True, cross_chromosome=False,
        validation_holdout=["chr2"], test_holdout=[], seed=seed,
        packed_sequence=packed,
    )


def measure(packed, window_bp, res, n_batches=24, workers=2):
    """(batches/s, bytes a batch) of `n_batches` timed after a warm one."""
    sampler = make_sampler(window_bp, res, packed)
    with PrefetchLoader(sampler, 1, num_workers=workers,
                        backend="process") as loader:
        loader.get(timeout=120)  # warm
        t0 = time.perf_counter()
        nbytes = 0
        for _ in range(n_batches):
            batch = loader.get(timeout=120)
            nbytes += sum(a.nbytes for a in batch)
        dt = time.perf_counter() - t0
    return n_batches / dt, nbytes / n_batches


def main(n_batches=24, device=None) -> dict:
    """Measure both formats and print the JSON line; returns it. `device`
    None means the CUDA card, whose name the line carries (raises without
    it); tests pass "cpu"."""
    device = resolve_device(device)
    window_bp = int(os.environ.get("ORCA_LOADER_WINDOW", "4000000"))
    res = 4000
    bps, nb_p = measure(True, window_bp, res, n_batches)
    bfs, nb_f = measure(False, window_bp, res, n_batches)
    line = {
        "metric": "prefetch_loader_batches_per_s",
        "window_bp": window_bp,
        "workers": 2,
        "packed_uint8": bps,
        "float32": bfs,
        "packed_batch_mb": nb_p / 1e6,
        "float32_batch_mb": nb_f / 1e6,
        "speedup": bps / bfs,
        **card_fields(device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m orca_tpu_torch.scripts.measure_loader",
        description="the prefetch loader's batches/s, packed and float32")
    p.add_argument("--batches", type=int, default=24,
                   help="timed batches per format")
    main(p.parse_args(sys.argv[1:]).batches)
