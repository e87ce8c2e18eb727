"""Model bundles (counterpart of orca_tpu/models/zoo.py): the 32 Mb
multiscale model's encoder, pyramid and per-level decoder parameters plus
its distance backgrounds."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.utils.config import resolve_device

LEVELS_32M = (1, 2, 4, 8, 16, 32)


def normmats_from_expectation(expected_log: np.ndarray, levels=LEVELS_32M,
                              nbins: int = 8000, crop: int = 250):
    """Distance-based background matrices per level: normmat[i, j] =
    exp(expected_log[|i - j|]) over `nbins` finest bins, block-averaged to
    crop x crop per level, with eps = min."""
    idx = np.abs(np.arange(nbins)[None, :] - np.arange(nbins)[:, None])
    normmat = np.exp(expected_log[idx])
    normmats, epss = {}, {}
    for level in levels:
        n = crop * level
        r = (
            np.reshape(normmat[:n, :n], (crop, level, crop, level))
            .mean(axis=1)
            .mean(axis=2)
        )
        normmats[level] = r
        epss[level] = float(np.min(r))
    return normmats, epss


@dataclasses.dataclass
class ModelBundle:
    """A 1-32 Mb multiscale model. Parameter trees hold tensors; the
    backgrounds stay numpy arrays on the host."""

    name: str
    encoder: dict  # bp -> 4 kb tower params
    pyramid: dict  # 4 kb -> 128 kb params
    decoders: Dict[int, dict]  # level -> Decoder params
    decoder_1pt: Optional[dict]  # Decoder_1m params added at level 1, or None
    normmats: Dict[int, np.ndarray]
    epss: Dict[int, float]
    upsample_mode: str = "bilinear"
    pyramid_up_pass: bool = True
    num_2d: int = 1  # output heads

    @property
    def levels(self):
        return tuple(sorted(self.decoders))

    def log_normmats(self) -> np.ndarray:
        """Stacked (levels, crop, crop) log backgrounds, coarsest first."""
        return np.stack(
            [np.log(self.normmats[lv])
             for lv in sorted(self.decoders, reverse=True)]
        ).astype(np.float32)


def _random_normmats(levels=LEVELS_32M, nbins: int = 8000, crop: int = 250):
    # smooth decaying expectation similar in shape to real micro-C
    d = np.arange(nbins, dtype=np.float64)
    expected_log = -1.5 * np.log1p(d) - 2.0
    return normmats_from_expectation(expected_log, levels=levels, nbins=nbins,
                                     crop=crop)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _map_params(bundle: ModelBundle, fn) -> ModelBundle:
    return dataclasses.replace(
        bundle,
        encoder=_map_tensors(bundle.encoder, fn),
        pyramid=_map_tensors(bundle.pyramid, fn),
        decoders={lv: _map_tensors(p, fn) for lv, p in bundle.decoders.items()},
        decoder_1pt=_map_tensors(bundle.decoder_1pt, fn),
    )


def random_32m_bundle(seed: int = 0, device=None, *, name: str = "random",
                      upsample_mode: str = "bilinear", up_pass: bool = True,
                      nbins: int = 8000, crop: int = 250) -> ModelBundle:
    """A 32 Mb bundle with torch's default conv init from `seed` (float32,
    BatchNorm unfolded), on `device` (None = CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    normmats, epss = _random_normmats(nbins=nbins, crop=crop)
    bundle = ModelBundle(
        name=name,
        encoder=encoders.init_encoder_tower(gen),
        pyramid=encoders.init_pyramid(gen, 5, up_pass),
        decoders={lv: decoders.init_decoder(gen) for lv in LEVELS_32M},
        decoder_1pt=decoders.init_decoder1m(gen) if up_pass else None,
        normmats=normmats,
        epss=epss,
        upsample_mode=upsample_mode,
        pyramid_up_pass=up_pass,
    )
    return _map_params(bundle, lambda t: t.to(device))


def fold_bundle(bundle: ModelBundle) -> ModelBundle:
    """Fold all BatchNorms into conv weights for inference."""
    return dataclasses.replace(
        bundle,
        encoder=fold_params(bundle.encoder, encoders.encoder_tower_spec()),
        pyramid=fold_params(
            bundle.pyramid, encoders.pyramid_spec(5, bundle.pyramid_up_pass)
        ),
        decoders={
            lv: fold_params(p, decoders.decoder_spec(bundle.num_2d))
            for lv, p in bundle.decoders.items()
        },
        decoder_1pt=(
            fold_params(bundle.decoder_1pt,
                        decoders.decoder1m_spec(bundle.num_2d))
            if bundle.decoder_1pt is not None
            else None
        ),
    )


def cast_bundle(bundle: ModelBundle, dtype: str) -> ModelBundle:
    """Cast a bundle's float32 parameters to `dtype` ('bfloat16' = serving
    precision; 'float32' returns the bundle unchanged)."""
    if dtype in ("float32", None):
        return bundle
    target = getattr(torch, dtype)
    return _map_params(
        bundle,
        lambda t: t.to(target) if t.dtype == torch.float32 else t,
    )


def load_bundle(path: str, device=None, dtype: Optional[str] = None):
    """Read a bundle pickled by the JAX package's `zoo.save_bundle` (see
    models.from_jax.load_bundle)."""
    from orca_tpu_torch.models.from_jax import load_bundle as _load

    return _load(path, device=device, dtype=dtype)
