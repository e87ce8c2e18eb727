"""The 32 Mb multiscale zoom-in cascade (counterpart of the 32 Mb part of
orca_tpu/predict/multiscale.py).

One window runs forward and reverse-complement as one batch: the encoder
tower and pyramid once, then six decoder levels from 32 down to 1, each on a
crop of the encodings chosen by the zoom target and refining the crop of its
parent's prediction; the Decoder_1m head adds in at level 1. The two
orientations are averaged at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from orca_tpu_torch.models.zoo import ModelBundle
from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.utils.config import get_config, resolve_device

BINS = 8000  # 4 kb bins in a 32 Mb window
CROP = 250
HALF = 125
LEVEL_ORDER = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class CascadeGeometry:
    """Static shape parameters of a zoom cascade: the production values are
    a 32 Mb window at 4 kb bins with 250-bin decoder crops; smaller ones run
    the same cascade in tests."""

    window_bp: int = 32_000_000
    bin_bp: int = 4000  # finest-level bin size in bp
    crop: int = 250  # decoder input size in bins

    @property
    def bins(self) -> int:
        return self.window_bp // self.bin_bp

    @property
    def half(self) -> int:
        return self.crop // 2

    def span_bp(self, m: int) -> int:
        """Window span of a level whose bins are `m` finest bins wide."""
        return self.crop * self.bin_bp * m


GEOM_32M = CascadeGeometry(32_000_000, 4000, 250)


def _device_sequence(sequence, device) -> torch.Tensor:
    """The one-hot on `device`, packed as quarter-scale uint8 when exactly
    representable ({0, 0.25, 1} values): 16x less host-to-device traffic.
    Other float inputs pass through unchanged."""
    arr = np.asarray(sequence)
    if arr.dtype == np.uint8:
        return torch.from_numpy(arr).to(device)
    q = arr * 4
    if q.size and q.min() >= 0 and q.max() <= 255 and np.all(q == np.round(q)):
        return torch.from_numpy(q.astype(np.uint8)).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _encode_32mb(bundle: ModelBundle, seq: torch.Tensor) -> Dict[int, torch.Tensor]:
    """One-hot (N, L, 4) -> encodings at levels 1..32 (finest L/4000 bins)."""
    feats = encoders.apply_encoder_tower(
        bundle.encoder, seq, halo_bp=get_config().encoder_halo_bp
    )
    encs = encoders.apply_pyramid(bundle.pyramid, feats, levels=5,
                                  up_pass=bundle.pyramid_up_pass)
    return dict(zip(LEVEL_ORDER, encs))


def _zoom_start_index(geom: CascadeGeometry, m: int, mpos: torch.Tensor,
                      wpos: torch.Tensor, start_bins: torch.Tensor,
                      rc: bool) -> torch.Tensor:
    """Zoom-window start in [0, half]; `m` is the level's bin size in finest
    bins. float32 arithmetic on tensors, in the JAX package's order, so the
    floor/ceil lands where it does there."""
    span4 = geom.span_bp(m) / 4.0
    halfwin = geom.window_bp / 2.0
    binw = float(geom.bin_bp)
    if not rc:
        raw = torch.floor(
            ((mpos - span4) - (wpos - halfwin + start_bins * binw)) / (binw * m)
        )
    else:
        raw = torch.ceil(
            ((wpos + halfwin - start_bins * binw) - (mpos + span4)) / (binw * m)
        )
    return torch.clamp(raw, 0, geom.half).to(torch.int32)


def _crop_rows(enc: torch.Tensor, starts: Sequence[int], size: int):
    """Per-row crop along axis 1: (B, L, C) -> (B, size, C)."""
    return torch.stack([e[s : s + size] for e, s in zip(enc, starts)])


def _crop_squares(pred: torch.Tensor, starts: Sequence[int], size: int):
    """Per-row square crop: (B, H, W, C) -> (B, size, size, C)."""
    return torch.stack(
        [p[s : s + size, s : s + size] for p, s in zip(pred, starts)]
    )


def _decode_level(bundle: ModelBundle, geom: CascadeGeometry, level: int,
                  enc_crop, log_nm: np.ndarray, start_bins: torch.Tensor,
                  mpos: torch.Tensor, wpos: torch.Tensor, coarse):
    """One decoder level of the orientation-batched cascade; rows [0, B/2)
    are forward, [B/2, B) reverse complement. Returns (pred, next
    start_bins, next coarse)."""
    b = enc_crop.shape[0]
    n = b // 2
    nm = torch.as_tensor(log_nm, device=enc_crop.device)
    nm = nm[:, :, None] if nm.dim() == 2 else nm.permute(1, 2, 0)
    distenc = nm[None].expand(b, geom.crop, geom.crop, bundle.num_2d)
    pred = decoders.apply_decoder(
        bundle.decoders[level], enc_crop, distenc, coarse,
        num_2d=bundle.num_2d, upsample_mode=bundle.upsample_mode,
    )
    if level == 1 and bundle.decoder_1pt is not None:
        pred = pred + decoders.apply_decoder1m(
            bundle.decoder_1pt, enc_crop, num_2d=bundle.num_2d
        )
    start_index = torch.cat([
        _zoom_start_index(geom, level, mpos, wpos, start_bins[:n], rc=False),
        _zoom_start_index(geom, level, mpos, wpos, start_bins[n:], rc=True),
    ])
    next_start = start_bins + start_index * level
    coarse_next = _crop_squares(pred, start_index.tolist(), geom.half)
    return pred, next_start, coarse_next


def _combine_orientations(pred: torch.Tensor) -> torch.Tensor:
    n = pred.shape[0] // 2
    return (0.5 * pred[:n] + 0.5 * torch.flip(pred[n:], dims=(1, 2))).float()


def _cascade_32mb(bundle: ModelBundle, geom: CascadeGeometry, seq, mpos, wpos,
                  log_normmats: np.ndarray):
    """Full fwd+RC cascade; returns (stacked (6, N, crop, crop, C) float32,
    starts (6,) int32) on the sequence's device."""
    n = seq.shape[0]
    seq2 = torch.cat([seq, torch.flip(seq, dims=(1, 2))])
    encs = _encode_32mb(bundle, seq2)
    device = seq.device
    start_bins = torch.zeros(2 * n, dtype=torch.int32, device=device)
    mpos = torch.tensor(mpos, dtype=torch.float32, device=device)
    wpos = torch.tensor(wpos, dtype=torch.float32, device=device)
    coarse = None
    preds, starts = [], []
    for j, level in enumerate(sorted(bundle.decoders, reverse=True)):
        starts.append(start_bins[:n])
        enc_crop = _crop_rows(encs[level], (start_bins // level).tolist(),
                              geom.crop)
        pred, start_bins, coarse = _decode_level(
            bundle, geom, level, enc_crop, log_normmats[j], start_bins, mpos,
            wpos, coarse,
        )
        preds.append(_combine_orientations(pred))
    return torch.stack(preds), torch.stack([s[0] for s in starts])


def _downsample_target(target: np.ndarray, start: int, factor: int,
                       nan_thresh: float, crop_bins: int = CROP):
    """NaN-aware block average of an observed matrix crop to crop_bins^2,
    over an optional leading feature axis."""
    n = crop_bins * factor
    squeeze = target.ndim == 2
    if squeeze:
        target = target[None]
    crop = target[:, start : start + n, start : start + n]
    r = crop.reshape(target.shape[0], crop_bins, factor, crop_bins, factor)
    with np.errstate(invalid="ignore"):
        avg = np.nanmean(np.nanmean(r, axis=4), axis=2)
    nanfrac = np.isnan(r).mean(axis=(2, 4))
    avg[nanfrac > nan_thresh] = np.nan
    return avg[0] if squeeze else avg


def genomepredict(
    sequence: np.ndarray,
    mchr: str,
    mpos: int = -1,
    wpos: int = -1,
    models: Sequence[ModelBundle] = (),
    targets: Optional[List[np.ndarray]] = None,
    annotation=None,
    nan_thresh: float = 1.0,
    geometry: CascadeGeometry = GEOM_32M,
    device=None,
) -> dict:
    """Multiscale 32 Mb prediction: returns a dict with keys
    predictions/experiments/normmats/start_coords/end_coords/chr/annos.

    sequence: (1, window_bp, 4) one-hot (float, or uint8 quarter-scale).
    models: ModelBundles whose parameters live on `device` (None = CUDA).
    """
    device = resolve_device(device)
    seq = _device_sequence(sequence, device)
    allpreds, allstarts = [], []
    with torch.inference_mode():
        for bundle in models:
            preds, starts = _cascade_32mb(
                bundle, geometry, seq, mpos, wpos, bundle.log_normmats()
            )
            allpreds.append(preds.cpu().numpy())
            allstarts.append(starts.cpu().numpy())

    lvl_list = sorted(models[0].decoders, reverse=True)
    output = {}
    # (crop, crop) maps for single-head models; (num_2d, crop, crop) for
    # multi-head ones
    output["predictions"] = [
        [
            p[j][0, :, :, 0] if p[j].shape[-1] == 1
            else np.moveaxis(p[j][0], -1, 0)
            for j in range(len(lvl_list))
        ]
        for p in allpreds
    ]
    if targets is not None:
        alltargets = []
        for i, bundle in enumerate(models):
            ts = []
            for j, level in enumerate(lvl_list):
                t = np.asarray(targets[i])
                if t.ndim == 3 and t.shape[0] == 1:
                    t = t[0]
                target_r = _downsample_target(
                    t, int(allstarts[i][j]), level, nan_thresh,
                    crop_bins=geometry.crop,
                )
                eps = bundle.epss[level]
                with np.errstate(invalid="ignore", divide="ignore"):
                    ts.append(
                        np.log((target_r + eps) / (bundle.normmats[level] + eps))
                    )
            alltargets.append(ts)
        output["experiments"] = alltargets
    else:
        output["experiments"] = None
    starts0 = allstarts[0]
    halfwin = geometry.window_bp // 2
    output["start_coords"] = [
        int(wpos - halfwin + s * geometry.bin_bp) for s in starts0
    ]
    output["end_coords"] = [
        int(output["start_coords"][j] + geometry.window_bp / 2**j)
        for j in range(len(lvl_list))
    ]
    output["chr"] = mchr
    output["annos"] = _process_annotation(
        annotation, starts0, [geometry.crop * lv for lv in lvl_list],
        geometry.bins,
    )
    output["normmats"] = [[m.normmats[lv] for lv in lvl_list] for m in models]
    return output


def _process_annotation(annotation, starts, window_bins, total_bins=BINS):
    """Window-relative annotation rescaling per level: `starts` and
    `window_bins` are in finest-bin units."""
    if annotation is None:
        return None
    annos = []
    for j, nbins in enumerate(window_bins):
        newstart = starts[j] / float(total_bins)
        newend = (starts[j] + nbins) / float(total_bins)
        anno_r = []
        for r in annotation:
            if len(r) == 3:
                if not (r[0] >= newend or r[1] <= newstart):
                    anno_r.append(
                        (
                            np.fmax((r[0] - newstart) / (newend - newstart), 0),
                            np.fmin((r[1] - newstart) / (newend - newstart), 1),
                            r[2],
                        )
                    )
            else:
                if newstart <= r[0] < newend:
                    anno_r.append(((r[0] - newstart) / (newend - newstart), r[1]))
        annos.append(anno_r)
    return annos
