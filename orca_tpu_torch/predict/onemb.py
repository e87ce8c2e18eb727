"""Standalone 1 Mb-model prediction and batched window screening
(counterpart of orca_tpu/predict/onemb.py).

  * `predict_1m`: the forward over a batch of 1 Mb windows, optionally with
    the 1D chromatin tracks and/or averaged with the reverse complement;
  * `screen_windows`: many windows (e.g. a variant's ref/alt pairs across
    loci) in chunks of a fixed batch size.

A 1 Mb window runs the encoder tower as one piece, so a call launches each
fused encoder kernel once on the card whatever its batch size.

The forward runs as module-level steps, each looked up at call time, so a
caller can wrap or replace one: the packed window's copy
(`multiscale._device_sequence`, span `orca.input_copy`), the tower
(`multiscale._tower`, `orca.tower`), the 2-D stack (`_decode_1m`,
`orca.onemb.decode`), the track head (`_tracks_1m`, `orca.onemb.tracks`),
the reverse-complement average (`_combine_rc`) and the host fetches
(`orca.sync`). The counters `onemb_windows` and `onemb_rows` (the rows
through the net, reverse complements included) count each call.
`decoders.apply_net` stays the training path's forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orca_tpu_torch.models.zoo import Model1MBundle
from orca_tpu_torch.nn import decoders
from orca_tpu_torch.nn.core import apply_block
from orca_tpu_torch.predict import multiscale
from orca_tpu_torch.utils import profiling
from orca_tpu_torch.utils.config import resolve_device


def _decode_1m(net: dict, feats: torch.Tensor) -> torch.Tensor:
    """The 2-D stack: the pairwise map of the tower's (N, bins, 128) output
    through `Decoder_1m` -> (N, bins, bins, 1)."""
    with profiling.span("orca.onemb.decode"):
        return decoders.apply_decoder1m_mat(net["decoder"],
                                            decoders.pairwise(feats))


def _tracks_1m(net: dict, feats: torch.Tensor, num_1d: int) -> torch.Tensor:
    """The 1-D track head `final_1d` on the tower's output ->
    (N, bins, num_1d)."""
    with profiling.span("orca.onemb.tracks"):
        return apply_block(net["final_1d"], decoders.final1d_spec(num_1d),
                           feats)


def _combine_rc(pred: torch.Tensor, tracks: Optional[torch.Tensor], n: int):
    """The first n rows averaged with the reverse-complement rows after
    them: maps flipped on both axes, tracks on positions."""
    pred = 0.5 * pred[:n] + 0.5 * torch.flip(pred[n:], dims=(1, 2))
    if tracks is not None:
        tracks = 0.5 * tracks[:n] + 0.5 * torch.flip(tracks[n:], dims=(1,))
    return pred, tracks


def _net_forward(bundle: Model1MBundle, seq: torch.Tensor, with_1d: bool,
                 rc_average: bool):
    # The JAX package expands a uint8 one-hot to the compute dtype here; the
    # port keeps it packed, the form the card's first encoder kernel reads,
    # and the tower expands it to the same values (x 0.25 is exact).
    x = seq
    if rc_average:
        x = torch.cat([x, torch.flip(x, dims=(1, 2))])
    profiling.count("onemb_windows", seq.shape[0])
    profiling.count("onemb_rows", x.shape[0])
    feats = multiscale._tower(bundle.net["encoder"], x, None)
    pred = _decode_1m(bundle.net, feats)
    tracks = (_tracks_1m(bundle.net, feats, bundle.num_1d)
              if with_1d and bundle.num_1d else None)
    if rc_average:
        pred, tracks = _combine_rc(pred, tracks, seq.shape[0])
    if tracks is not None:
        return pred.float(), tracks.float()
    return pred.float()


def predict_1m(bundle: Model1MBundle, sequence, with_1d: bool = False,
               rc_average: bool = False, *, device=None):
    """(N, 1e6, 4) one-hot (float, or uint8 quarter-scale) -> (N, 250, 250, 1)
    map [+ (N, 250, num_1d) tracks], float32 numpy; the bundle's parameters
    live on `device` (None = CUDA)."""
    device = resolve_device(device)
    seq = multiscale._device_sequence(sequence, device)
    with torch.inference_mode():
        out = _net_forward(bundle, seq, with_1d, rc_average)
        with profiling.span("orca.sync"):
            if isinstance(out, tuple):
                return out[0].cpu().numpy(), out[1].cpu().numpy()
            return out.cpu().numpy()


def log_fold_map(bundle: Model1MBundle, pred: np.ndarray) -> np.ndarray:
    """The predicted map is a log fold over the background; this adds the
    background back, log(exp(pred) * normmat), for display."""
    return pred[..., 0] + np.log(bundle.normmats[1])


def screen_windows(bundle, sequences, batch_size: int = 4, predict_fn=None,
                   *, device=None) -> np.ndarray:
    """Batched screening over many 1 Mb windows: (W, 1e6, 4) -> (W, 250, 250,
    1), in chunks of `batch_size` windows; a short last chunk is padded with
    copies of its last window, whose outputs are dropped."""
    if predict_fn is None:
        device = resolve_device(device)

        def predict_fn(b, s):
            return predict_1m(b, s, device=device)
    outs = []
    w = len(sequences)
    for i in range(0, w, batch_size):
        chunk = np.asarray(sequences[i : i + batch_size])
        if len(chunk) < batch_size:
            pad = batch_size - len(chunk)
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            outs.append(predict_fn(bundle, chunk)[: w - i])
        else:
            outs.append(predict_fn(bundle, chunk))
    return np.concatenate(outs, axis=0)
