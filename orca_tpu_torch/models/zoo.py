"""Model bundles (counterpart of orca_tpu/models/zoo.py): each multiscale
model's encoder, pyramid and per-level decoder parameters plus its distance
backgrounds (`normmats`/`epss` for the 1-32 Mb models,
`background_cis`/`background_trans` for the 32-256 Mb models)."""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.utils.config import resolve_device

LEVELS_32M = (1, 2, 4, 8, 16, 32)
LEVELS_256M = (32, 64, 128, 256)


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


@dataclasses.dataclass
class Model256MBundle:
    """A 32-256 Mb model: the 32 Mb model's tower and pyramid (`pyramid1`),
    then a 3-level pyramid to 1 Mb bins. Parameter trees hold tensors; the
    backgrounds stay numpy on the host."""

    name: str
    encoder: dict  # bp -> 4 kb tower
    pyramid1: dict  # 4 kb -> 128 kb
    pyramid: dict  # 128 kb -> 1024 kb
    decoders: Dict[int, dict]
    background_cis: np.ndarray  # exp() 1D expectation at 32 kb + NaN tail
    background_trans: float
    upsample_mode: str = "bilinear"

    @property
    def levels(self):
        return tuple(sorted(self.decoders))


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


def _map_params(bundle, fn):
    """The bundle (either class) with `fn` applied to every parameter
    tensor; the numpy backgrounds are left as they are."""
    return dataclasses.replace(bundle, **{
        f.name: _map_tensors(getattr(bundle, f.name), fn)
        for f in dataclasses.fields(bundle)
    })


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


def random_256m_bundle(seed: int = 0, device=None, *,
                       name: str = "random_256m") -> Model256MBundle:
    """A 256 Mb bundle with torch's default conv init from `seed` (float32,
    BatchNorm unfolded), on `device` (None = CUDA). The cis background is a
    smooth decay over 8000 bins of 32 kb with a NaN tail, as the JAX
    package's random bundle has."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = np.arange(8000, dtype=np.float64)
    bundle = Model256MBundle(
        name=name,
        encoder=encoders.init_encoder_tower(gen),
        pyramid1=encoders.init_pyramid(gen, 5, True),
        pyramid=encoders.init_pyramid(gen, 3, True),
        decoders={lv: decoders.init_decoder(gen) for lv in LEVELS_256M},
        background_cis=np.hstack(
            [np.exp(-1.2 * np.log1p(d) - 3.0), np.repeat(np.nan, 2000)]
        ),
        background_trans=float(np.exp(-9.0)),
    )
    return _map_params(bundle, lambda t: t.to(device))


def fold_256m_bundle(bundle: Model256MBundle) -> Model256MBundle:
    """Fold all BatchNorms into conv weights for inference (256 Mb family)."""
    return dataclasses.replace(
        bundle,
        encoder=fold_params(bundle.encoder, encoders.encoder_tower_spec()),
        pyramid1=fold_params(bundle.pyramid1, encoders.pyramid_spec(5, True)),
        pyramid=fold_params(bundle.pyramid, encoders.pyramid_spec(3, True)),
        decoders={
            lv: fold_params(p, decoders.decoder_spec(1))
            for lv, p in bundle.decoders.items()
        },
    )


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


def cast_bundle(bundle, dtype: str):
    """Cast a bundle's (either class) float32 parameters to `dtype`
    ('bfloat16' = serving precision; 'float32' returns the bundle
    unchanged)."""
    if dtype in ("float32", None):
        return bundle
    target = getattr(torch, dtype)
    return _map_params(
        bundle,
        lambda t: t.to(target) if t.dtype == torch.float32 else t,
    )


def save_bundle(bundle, path: str) -> None:
    """Pickle a bundle (either class) with its parameters as float32 numpy
    arrays, the form the JAX package's `zoo.save_bundle` writes; `load_bundle`
    reads both."""
    host = _map_params(bundle, lambda t: t.detach().float().cpu().numpy())
    with open(path, "wb") as f:
        pickle.dump(host, f)


def load_bundle(path: str, device=None, dtype: Optional[str] = None):
    """Read a bundle pickled by `save_bundle` or by the JAX package's
    `zoo.save_bundle` (see models.from_jax.load_bundle)."""
    from orca_tpu_torch.models.from_jax import load_bundle as _load

    return _load(path, device=device, dtype=dtype)


def _needs(item: str, what: str):
    raise NotImplementedError(
        f"{what} is not ported to orca_tpu_torch yet (ROADMAP {item}); "
        "convert the model with the JAX package and save it as an "
        "orca_<name>.bundle pickle"
    )


def load_32m_bundle(model_dir: str, resource_dir: str, name: str,
                    fold: bool = True, nbins: int = 8000,
                    crop: int = 250) -> ModelBundle:
    """A 1-32 Mb bundle from the reference's torch statedicts: needs the
    statedict converter (ROADMAP A13)."""
    _needs("A13", "loading a 32 Mb bundle from torch statedicts")


def load_256m_bundle(model_dir: str, resource_dir: str, name: str,
                     fold: bool = True) -> Model256MBundle:
    """A 32-256 Mb bundle from the reference's torch statedicts: needs the
    statedict converter (ROADMAP A13)."""
    _needs("A13", "loading a 256 Mb bundle from torch statedicts")


def load_leukemia_bundle(model_dir: str, resource_dir: str, name: str,
                         fold: bool = True) -> ModelBundle:
    """A multi-cell-type leukemia bundle: needs the variant families
    (ROADMAP A12)."""
    _needs("A12", "the leukemia model family")


def load_1m_bundle(model_dir: str, resource_dir: str, name: str):
    """A standalone 1 Mb bundle: needs the 1 Mb family (ROADMAP A11)."""
    _needs("A11", "the 1 Mb model family")
