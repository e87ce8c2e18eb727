"""Each step of a bf16 32 Mb request timed on the CUDA card (counterpart of
the JAX package's scripts/profile_cascade.py), printed under the JAX
script's labels in its order:

  channel setup              the CUDA context and the first device-to-host
                             fetch
  seq H2D (128MB packed)     the packed (1, 32 Mb, 4) uint8 one-hot's
                             pageable copy to the card
  full cascade               `multiscale._cascade_32mb`
  encode_32mb_jit (...)      encoder + pyramid on fwd + RC
                             (`multiscale._encode_32mb`; the label is the JAX
                             function's name)
  tower only (fwd+RC)        `encoders.apply_encoder_tower` (the fused
                             conv-chain kernels)
  pyramid only               `encoders.apply_pyramid`
  one decoder level (...)    `multiscale._decode_level` at level 1, B=2, with
                             a coarse map, without and with the 1 Mb head

then the card's name and power limit on a `device:` line. A step's time
is the mean of `n` runs queued back to back and ended by one
host fetch, after a warm run; "single incl. fetch" is one run with its
fetch. The bundle is a random folded H1-ESC-architecture bundle cast to
bf16 (the backgrounds come from its float32 host data).

    python -m orca_tpu_torch.scripts.profile_cascade [--n N]

`make_steps` builds the timed callables from a bundle, a geometry, a packed
sequence and a device, so that a test runs them at a small geometry.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from orca_tpu_torch.nn import encoders
from orca_tpu_torch.predict.multiscale import (
    GEOM_32M,
    LEVEL_ORDER,
    CascadeGeometry,
    _cascade_32mb,
    _crop_rows,
    _decode_level,
    _encode_32mb,
)
from orca_tpu_torch.scripts._common import card_fields, fetch, print_card
from orca_tpu_torch.utils.config import get_config, resolve_device


def timeit(name, f, n=3):
    """Print and return the seconds of one of `n` queued runs of `f`."""
    fetch(f())  # warm (first-shape caches, cuDNN's plans)
    rtt0 = time.perf_counter()
    fetch(f())
    single = time.perf_counter() - rtt0
    t0 = time.perf_counter()
    for _ in range(n):
        out = f()  # launches queue on the card back to back
    fetch(out)  # one wait at the end
    dt = (time.perf_counter() - t0) / n
    print(f"{name}: {dt*1000:.1f} ms  (single incl. fetch: {single*1000:.1f})",
          flush=True)
    return dt


def make_steps(bundle, geometry: CascadeGeometry, seq: torch.Tensor):
    """[(label, callable)] of the request's steps on `seq`, a packed
    (1, window, 4) uint8 sequence on the bundle's device. Each callable
    returns what the JAX script's timed function returns: the cascade's
    (preds, starts), the encodings in level order 1..32, the tower's
    features, the pyramid's encodings, the decoder level's (pred, next
    starts, next coarse)."""
    device = seq.device
    log_normmats = bundle.log_normmats()
    mid = geometry.window_bp / 2
    seq2 = torch.cat([seq, torch.flip(seq, dims=(1, 2))])
    halo = get_config().encoder_halo_bp

    def cascade():
        return _cascade_32mb(bundle, geometry, seq, mid, mid, log_normmats)

    def encode():
        encs = _encode_32mb(bundle, seq2)
        return tuple(encs[lv] for lv in LEVEL_ORDER)

    def tower():
        return encoders.apply_encoder_tower(bundle.encoder, seq2, halo_bp=halo)

    feats = tower()

    def pyramid():
        return tuple(encoders.apply_pyramid(bundle.pyramid, feats, levels=5,
                                            up_pass=bundle.pyramid_up_pass))

    # one decoder level (with coarse). Level 1 also adds the decoder_1pt
    # head: time both variants so the level-1 number matches what the
    # cascade runs
    enc1 = _crop_rows(encode()[0], [0, 0], geometry.crop)
    dtype = enc1.dtype
    coarse = torch.zeros((2, geometry.half, geometry.half, 1), dtype=dtype,
                         device=device)
    zeros = torch.zeros((2,), dtype=torch.int32, device=device)
    mpos = torch.tensor(mid, dtype=torch.float32, device=device)
    steps = [
        ("full cascade", cascade),
        ("encode_32mb_jit (tower+pyramid, fwd+RC)", encode),
        ("tower only (fwd+RC)", tower),
        ("pyramid only", pyramid),
    ]
    for name, b in (("no 1pt", dataclasses.replace(bundle, decoder_1pt=None)),
                    ("with 1pt", bundle)):
        steps.append((
            f"one decoder level (B=2, coarse, {name})",
            lambda b=b: _decode_level(b, geometry, 1, enc1, log_normmats[5],
                                      zeros, mpos, mpos, coarse),
        ))
    return steps


def main(n=3, geometry: CascadeGeometry = GEOM_32M, device=None,
         bundle=None) -> dict:
    """Print every labelled line; returns {label: seconds} with the card's
    fields. `device` None means the CUDA card (raises without it); tests
    pass "cpu", a small geometry and a bundle for it."""
    from orca_tpu_torch.models import zoo

    device = resolve_device(device)
    if bundle is None:
        bundle = zoo.cast_bundle(zoo.fold_bundle(zoo.random_32m_bundle(
            seed=0, device=device, nbins=geometry.bins, crop=geometry.crop,
        )), "bfloat16")

    t0 = time.perf_counter()
    torch.zeros((1,), dtype=torch.float32, device=device).cpu()
    setup_s = time.perf_counter() - t0
    print(f"channel setup: {setup_s:.4f} s", flush=True)

    codes = np.random.RandomState(0).randint(0, 4, size=geometry.window_bp)
    host = torch.from_numpy((np.eye(4, dtype=np.uint8) * 4)[codes][None])
    t0 = time.perf_counter()
    seq = host.to(device)
    fetch(seq[:, :1])
    copy_s = time.perf_counter() - t0
    print(f"seq H2D (128MB packed): {copy_s:.4f} s", flush=True)

    out = {"channel setup": setup_s, "seq H2D (128MB packed)": copy_s}
    with torch.inference_mode():
        for label, f in make_steps(bundle, geometry, seq):
            out[label] = timeit(label, f, n)
    card = card_fields(device)
    print_card(card)
    out.update(card)
    return out


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m orca_tpu_torch.scripts.profile_cascade",
        description="each step of a bf16 32 Mb request on the CUDA card")
    p.add_argument("--n", type=int, default=3, help="timed runs a step")
    main(p.parse_args(sys.argv[1:]).n)
