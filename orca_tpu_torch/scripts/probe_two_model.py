"""Probe: two-model cascade strategies on the CUDA card (counterpart of the
JAX package's scripts/probe_two_model.py).

Measures (bf16, 32 Mb window, fwd+RC), under the JAX script's labels:
  1. encoder-only time (where the FLOPs go);
  2. one-model full cascade;
  3. two models in turn (what `genomepredict` does);
  4. the encoder at batch 4 (both models' fwd+RC as one tower run with one
     model's weights: an upper bound for batching the encoders);
  5. one decoder level of two models stacked on a model axis, against one
     model's;
then the four ratios of the JAX script and the card's name and power limit.

The stacked decode is the JAX script's `jax.vmap` over the model axis.
`torch.func.vmap` cannot run the port's decoder (its convs ask for the
channels-last memory format, which vmap refuses), so `stacked_decode`
stacks the models by hand into the same computation: the model axis is
folded into the channels, each conv is one grouped cuDNN convolution
(groups = models) in channels-last, and the elementwise steps broadcast
over the model axis.

    python -m orca_tpu_torch.scripts.probe_two_model [--iters N]

Decides whether model-axis batching is worth wiring into `genomepredict`.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from orca_tpu_torch.nn import decoders
from orca_tpu_torch.ops import nn_ops
from orca_tpu_torch.predict.multiscale import (
    GEOM_32M,
    CascadeGeometry,
    _cascade_32mb,
    _encode_32mb,
)
from orca_tpu_torch.scripts._common import card_fields, fetch, print_card
from orca_tpu_torch.utils.config import resolve_device
from orca_tpu_torch.utils.tree import tree_map


def stack_params(*trees):
    """Parameter trees of one structure -> one tree of stacked leaves (a
    leading model axis)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _stacked_conv2d(x, w, b, dilation):
    """One conv of M models at once. x (N, H, W, M, Cin); w (M, Kh, Kw, Cin,
    Cout), b (M, Cout) -> (N, H, W, M, Cout): a grouped convolution over
    the models in channels-last, 'same' padding as `nn_ops.conv2d`."""
    n, h, wd, m, cin = x.shape
    cout = w.shape[-1]
    dtype = torch.promote_types(x.dtype, w.dtype)
    xt = x.to(dtype).reshape(n, h, wd, m * cin).permute(0, 3, 1, 2)
    wt = w.to(dtype).permute(0, 4, 3, 1, 2).reshape(
        m * cout, cin, w.shape[1], w.shape[2]).contiguous(
            memory_format=torch.channels_last)
    ph = dilation * (w.shape[1] - 1) // 2
    pw = dilation * (w.shape[2] - 1) // 2
    with nn_ops.full_fp32():
        out = F.conv2d(xt.contiguous(memory_format=torch.channels_last), wt,
                       b.to(dtype).reshape(m * cout), padding=(ph, pw),
                       dilation=dilation, groups=m)
    return out.permute(0, 2, 3, 1).reshape(n, h, wd, m, cout)


def _stacked_block(params, block, x):
    """`nn.core.apply_block` of a folded 2D block in inference, on stacked
    parameters and (N, H, W, M, C) activations."""
    if block.pool or block.upsample:
        raise ValueError("a decoder block neither pools nor upsamples")
    for p, unit in zip(params, block.units):
        if "bn" in p:
            raise ValueError("stacked_decode needs folded parameters")
        x = _stacked_conv2d(x, p["w"], p["b"], unit.dilation)
        if unit.relu:
            x = nn_ops.relu(x)
        if unit.sigmoid:
            x = nn_ops.sigmoid(x)
    return x


def _symmetrize(m):
    return 0.5 * m + 0.5 * m.transpose(1, 2)


def stacked_decode(dec, d1pt, enc_crop, log_nm, coarse, *, num_2d=1,
                   upsample_mode="bilinear"):
    """One decoder level plus the 1 Mb head for M models at once: what
    `decode_one` computes for each model. dec, d1pt: stacked folded trees;
    enc_crop (M, N, crop, 128); log_nm (crop, crop), shared; coarse (M, N,
    crop/2, crop/2, num_2d). Returns (M, N, crop, crop, num_2d)."""
    x = enc_crop.permute(1, 2, 0, 3)  # (N, crop, M, 128)
    n, crop, m, _ = x.shape
    spec = decoders.decoder_spec(num_2d)
    pair = x[:, :, None] + x[:, None]  # (N, crop, crop, M, 128)
    distenc = log_nm.to(x.dtype)[None, :, :, None, None].expand(
        n, crop, crop, m, num_2d)
    mat = torch.cat([pair, distenc], dim=-1)
    mat = _stacked_block(dec["lcombinerD"], spec["lcombinerD"], mat)
    mat = _stacked_block(dec["combinerD"], spec["combinerD"], mat) + mat
    y = coarse.to(x.dtype).permute(1, 2, 3, 0, 4)  # (N, h, w, M, num_2d)
    h = y.shape[1]
    y = y.reshape(n, h, h, m * num_2d)
    up = (nn_ops.upsample2d_bilinear(y, 2) if upsample_mode == "bilinear"
          else nn_ops.upsample2d_nearest(y, 2))
    cur = torch.cat([mat, up.reshape(n, crop, crop, m, num_2d)], dim=-1)
    cur = _stacked_block(dec["lcombiner"], spec["lcombiner"], cur)
    cur = _stacked_block(dec["combiner"], spec["combiner"], cur) + cur
    blocks = list(zip(spec["lconvtwos"], dec["lconvtwos"], spec["convtwos"],
                      dec["convtwos"]))
    # with a coarse pred the combiner pair replaces the first block
    for lb, lp, cb, cp in blocks[1:]:
        cur = _stacked_block(lp, lb, cur) + cur
        cur = _stacked_block(cp, cb, cur) + cur
    out = _symmetrize(_stacked_block(dec["final"], spec["final"], cur))

    spec1 = decoders.decoder1m_spec(num_2d)
    cur = pair
    for i, (lb, lp, cb, cp) in enumerate(zip(
            spec1["lconvtwos"], d1pt["lconvtwos"], spec1["convtwos"],
            d1pt["convtwos"])):
        lout = _stacked_block(lp, lb, cur)
        # the first block maps 128 -> 64 channels: no residual
        cur = lout if i == 0 else lout + cur
        cur = _stacked_block(cp, cb, cur) + cur
    out = out + _symmetrize(_stacked_block(d1pt["final"], spec1["final"],
                                           cur))
    return out.permute(3, 0, 1, 2, 4)


def decode_one(dec, d1pt, enc_crop, log_nm, coarse, *, num_2d=1,
               upsample_mode="bilinear"):
    """One model's decoder level plus its 1 Mb head: enc_crop (N, crop,
    128), log_nm (crop, crop), coarse (N, crop/2, crop/2, num_2d)."""
    n, crop, _ = enc_crop.shape
    distenc = log_nm[None, :, :, None].expand(n, crop, crop, num_2d)
    out = decoders.apply_decoder(dec, enc_crop, distenc, coarse,
                                 num_2d=num_2d, upsample_mode=upsample_mode)
    return out + decoders.apply_decoder1m(d1pt, enc_crop, num_2d=num_2d)


def make_steps(b0, b1, geometry: CascadeGeometry, seq: torch.Tensor):
    """[(label, callable, iters)] in the JAX script's order, on `seq`, a
    packed (1, window, 4) uint8 sequence on the bundles' device. The
    callables return what the JAX script's timed functions compute (their
    sums are the host fetch)."""
    device = seq.device
    log_nm = b0.log_normmats()
    mid = geometry.window_bp / 2
    seq2 = torch.cat([seq, torch.flip(seq, dims=(1, 2))])
    seq_b2 = torch.cat([seq, seq])
    seq4 = torch.cat([seq_b2, torch.flip(seq_b2, dims=(1, 2))])

    def enc_only():
        return _encode_32mb(b0, seq2)[1][:, :8]

    def one_model():
        return _cascade_32mb(b0, geometry, seq, mid, mid, log_nm)[0][-1]

    def two_seq():
        outs = []
        for b in (b0, b1):
            outs.append(_cascade_32mb(b, geometry, seq, mid, mid,
                                      log_nm)[0][-1])
            fetch(outs[-1])  # each model's host fetch, as the JAX loop
        return outs

    # both models' fwd+RC as one tower run with one model's weights
    def enc_b4():
        return _encode_32mb(b0, seq4)[1][:, :8]

    dtype = b0.decoders[1]["final"][0]["w"].dtype
    stacked_dec = stack_params(b0.decoders[1], b1.decoders[1])
    stacked_1pt = stack_params(b0.decoder_1pt, b1.decoder_1pt)
    enc_crop = torch.zeros((2, 2, geometry.crop, 128), dtype=dtype,
                           device=device)
    coarse = torch.zeros((2, 2, geometry.half, geometry.half, 1),
                         dtype=dtype, device=device)
    nm = torch.as_tensor(log_nm[-1], device=device)

    def dec_vm():
        return stacked_decode(stacked_dec, stacked_1pt, enc_crop, nm, coarse)

    def dec_one():
        return decode_one(b0.decoders[1], b0.decoder_1pt, enc_crop[0], nm,
                          coarse[0])

    return [
        ("encoder+pyramid (fwd+RC)", enc_only, 3),
        ("one-model cascade", one_model, 3),
        ("two-model sequential", two_seq, 3),
        ("encoder+pyramid batch-4 (one weight set)", enc_b4, 3),
        ("vmapped 2-model decode, one level", dec_vm, 5),
        ("single-model decode, one level", dec_one, 5),
    ]


def timeit(label, fn, iters=3):
    """Print and return the seconds of one call of `fn`, each call ended by
    a host fetch, after a warm call."""
    fetch(fn())  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        fetch(fn())
    dt = (time.perf_counter() - t0) / iters
    print(f"{label}: {dt*1000:.1f} ms", flush=True)
    return dt


def main(iters=None, geometry: CascadeGeometry = GEOM_32M, device=None,
         bundles=None) -> dict:
    """Print every labelled line and the ratios; returns {label: seconds}
    with the card's fields. `iters` (None: the JAX script's 3 and 5) sets
    every step's timed calls. `device` None means the CUDA card (raises
    without it); tests pass "cpu", a small geometry and two bundles."""
    from orca_tpu_torch.models import zoo

    device = resolve_device(device)
    if bundles is None:
        bundles = [zoo.cast_bundle(zoo.fold_bundle(zoo.random_32m_bundle(
            seed=s, device=device, nbins=geometry.bins, crop=geometry.crop,
        )), "bfloat16") for s in (0, 1)]
    codes = np.random.RandomState(0).randint(0, 4, size=geometry.window_bp)
    seq = torch.from_numpy(
        (np.eye(4, dtype=np.uint8) * 4)[codes][None]).to(device)
    torch.zeros((1,), device=device).cpu()  # CUDA context and first fetch

    t = {}
    with torch.inference_mode():
        for label, fn, n in make_steps(*bundles, geometry, seq):
            t[label] = timeit(label, fn, iters or n)
    t_enc, t_one, t_two, t_enc4, t_decvm, t_decone = t.values()
    print(f"\nencoder share of one-model cascade: {t_enc/t_one:.2f}")
    print(f"two-seq / one-model: {t_two/t_one:.2f}")
    print(f"encoder batch-4 / batch-2: {t_enc4/t_enc:.2f} "
          "(<2 => batching the encoder wins)")
    print(f"vmapped decode / single decode: {t_decvm/t_decone:.2f} "
          "(<2 => vmapping decoders wins)", flush=True)
    card = card_fields(device)
    print_card(card)
    t.update(card)
    return t


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m orca_tpu_torch.scripts.probe_two_model",
        description="two models in turn against two models stacked, bf16 "
                    "32 Mb on the CUDA card")
    p.add_argument("--iters", type=int, default=None,
                   help="timed calls a step (default: 3, and 5 for the "
                        "decodes)")
    main(p.parse_args(sys.argv[1:]).iters)
