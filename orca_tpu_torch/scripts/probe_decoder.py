"""Decoder-level timing at production shape (250x250, B=2 fwd+RC, bf16) on
the CUDA card (counterpart of the JAX package's scripts/probe_decoder.py),
under the JAX script's labels: the whole level, its 28 dilated residual
blocks alone, one k=3 conv per dilation (1, 2, 16, 64), and two matmul
"tap" ceilings (`torch.matmul`, the JAX script's `a @ w`); then the card's
name and power limit. No kernel of this package runs here: the decoders
are cuDNN convs.

The 28 blocks run as `nn.decoders.apply_decoder` runs them: in order, each
with the dilation of its place in the schedule (1, 2, 4, ..., 64) x 4, and
here each with its residual. (The JAX script scans the last 27 blocks in
groups of 9, so its scan body gives every group the first group's
dilations; this runs the decoder's own schedule.)

    python -m orca_tpu_torch.scripts.probe_decoder [--n N]

`make_inputs` and `make_steps` build the inputs and the timed callables so
that a test runs them at a small S.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from orca_tpu_torch.nn import decoders
from orca_tpu_torch.nn.core import apply_block, fold_params
from orca_tpu_torch.ops import nn_ops
from orca_tpu_torch.scripts._common import card_fields, fetch, print_card
from orca_tpu_torch.utils.config import resolve_device
from orca_tpu_torch.utils.tree import tree_map

DTYPE = torch.bfloat16
B, S = 2, 250
DILATIONS = (1, 2, 16, 64)


def timeit(name, f, n=10):
    """Print the mean seconds of `n` queued calls of `f` (after a warm
    call), ended by one host fetch; returns them."""
    fetch(f())
    t0 = time.perf_counter()
    for _ in range(n):
        out = f()
    fetch(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name}: {dt*1000:.2f} ms", flush=True)
    return dt


def make_inputs(device, s=S, b=B, dtype=DTYPE) -> dict:
    """The JAX script's inputs, drawn from RandomState(0) in its order, as
    float32 numpy arrays and as `dtype` tensors on `device`."""
    rng = np.random.RandomState(0)
    host = {
        "x": rng.rand(b, s, 128).astype(np.float32),
        "distenc": rng.rand(2, s, s, 1).astype(np.float32),
        "coarse": rng.rand(b, s // 2, s // 2, 1).astype(np.float32),
        "cur0": rng.rand(b, s, s, 64).astype(np.float32),
        "w": rng.rand(3, 3, 64, 64).astype(np.float32) * 0.1,
        "b": rng.rand(64).astype(np.float32),
        "wf": rng.rand(64, 64).astype(np.float32),
        "wp": rng.rand(128, 128).astype(np.float32),
    }
    dev = {k: torch.from_numpy(v).to(device=device, dtype=dtype)
           for k, v in host.items()}
    return {"host": host, "device": dev}


def blocks(params, cur):
    """The decoder's 28 dilated residual block pairs on (N, S, S, 64)."""
    spec = decoders.decoder_spec(1)
    for lb, lp, cb, cp in zip(spec["lconvtwos"], params["lconvtwos"],
                              spec["convtwos"], params["convtwos"]):
        cur = apply_block(lp, lb, cur) + cur
        cur = apply_block(cp, cb, cur) + cur
    return cur


def make_steps(params, inputs):
    """[(label, callable)] in the JAX script's order; `inputs` is
    `make_inputs(...)["device"]`."""
    t = inputs
    bsz, s = t["cur0"].shape[:2]
    steps = [
        ("full decoder level (combiners + 28 blocks + final)",
         lambda: decoders.apply_decoder(params, t["x"], t["distenc"],
                                        t["coarse"], num_2d=1,
                                        upsample_mode="bilinear")),
        ("28 dilated residual blocks", lambda: blocks(params, t["cur0"])),
    ]
    for d in DILATIONS:
        steps.append((f"  one k=3 conv dilation={d}",
                      lambda d=d: nn_ops.conv2d(t["cur0"], t["w"], t["b"],
                                                dilation=d)))
    # pure dot ceiling: the same contraction as one conv's 9 taps
    xf = t["cur0"].reshape(bsz * s * s, 64)
    steps.append(("  one (125000,64)@(64,64) dot (tap unit)",
                  lambda: xf @ t["wf"]))
    # packed-lane ceiling: (62500,128)@(128,128)
    xp = t["cur0"].reshape(bsz * s * s // 2, 128)
    steps.append(("  one (62500,128)@(128,128) dot (packed tap)",
                  lambda: xp @ t["wp"]))
    return steps


def main(n=10, device=None, s=S) -> dict:
    """Print every labelled line; returns {label: seconds} with the card's
    fields. `device` None means the CUDA card (raises without it); tests
    pass "cpu" and a small `s`."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    params = fold_params(decoders.init_decoder(gen), decoders.decoder_spec(1))
    params = tree_map(lambda p: p.to(device=device, dtype=DTYPE), params)
    torch.zeros((1,), device=device).cpu()  # CUDA context and first fetch
    inputs = make_inputs(device, s)["device"]
    out = {}
    with torch.inference_mode():
        for label, f in make_steps(params, inputs):
            out[label] = timeit(label, f, n)
    card = card_fields(device)
    print_card(card)
    out.update(card)
    return out


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m orca_tpu_torch.scripts.probe_decoder",
        description="one bf16 decoder level, its blocks and convs on the "
                    "CUDA card")
    p.add_argument("--n", type=int, default=10, help="timed calls a step")
    main(p.parse_args(sys.argv[1:]).n)
