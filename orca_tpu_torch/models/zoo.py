"""Model bundles (counterpart of orca_tpu/models/zoo.py): each model's
parameters plus its distance backgrounds (`normmats`/`epss` for the 1-32 Mb
and the standalone 1 Mb models, `background_cis`/`background_trans` for the
32-256 Mb models). Bundles come from the reference's torch statedicts
(`load_*_bundle`, through models/convert.py), from pickles (`load_bundle`),
or from a seed (`random_*_bundle`)."""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from orca_tpu_torch.models import convert
from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.nn.core import fold_params
from orca_tpu_torch.utils.config import resolve_device
from orca_tpu_torch.utils.tree import tree_map

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


def normmat_1m_from_expectation(expected_log: np.ndarray):
    """The 1 Mb model's background: 1000 bins of 1 kb, averaged 4x to
    250 x 250."""
    e = expected_log[:1000]
    normmat = np.exp(e[np.abs(np.arange(1000)[None, :]
                              - np.arange(1000)[:, None])])
    r = np.reshape(normmat, (250, 4, 250, 4)).mean(axis=1).mean(axis=2)
    return {1: r}, {1: float(np.min(r))}


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
class Model1MBundle:
    """A standalone 1 Mb model: the `decoders.init_net` tree (tower,
    `Decoder_1m`, the 1D track head when num_1d is set). Parameters hold
    tensors; the backgrounds stay numpy on the host."""

    name: str
    net: dict  # Net params: encoder/decoder/final_1d
    num_1d: Optional[int]
    normmats: Dict[int, np.ndarray]
    epss: Dict[int, float]


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
    """`fn` on every tensor leaf; other leaves (None, numpy) as they are."""
    return tree_map(lambda t: fn(t) if isinstance(t, torch.Tensor) else t,
                    tree)


def _map_params(bundle, fn):
    """The bundle (any class) with `fn` applied to every parameter tensor;
    the numpy backgrounds are left as they are."""
    return dataclasses.replace(bundle, **{
        f.name: _map_tensors(getattr(bundle, f.name), fn)
        for f in dataclasses.fields(bundle)
    })


def random_32m_bundle(seed: int = 0, name: str = "random",
                      upsample_mode: str = "bilinear", up_pass: bool = True,
                      nbins: int = 8000, crop: int = 250, *,
                      device=None) -> ModelBundle:
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


def random_256m_bundle(seed: int = 0, name: str = "random_256m", *,
                       device=None) -> Model256MBundle:
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


def random_1m_bundle(seed: int = 0, num_1d: Optional[int] = 32, device=None,
                     *, name: str = "random_1m") -> Model1MBundle:
    """A standalone 1 Mb bundle with torch's default conv init from `seed`
    (float32, BatchNorm unfolded), on `device` (None = CUDA), with the
    smooth background of the JAX package's 1 Mb tests."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = np.arange(1000, dtype=np.float64)
    normmats, epss = normmat_1m_from_expectation(-1.0 * np.log1p(d) - 2.0)
    bundle = Model1MBundle(name=name, net=decoders.init_net(gen, num_1d),
                           num_1d=num_1d, normmats=normmats, epss=epss)
    return _map_params(bundle, lambda t: t.to(device))


def fold_1m_bundle(bundle: Model1MBundle) -> Model1MBundle:
    """Fold all BatchNorms into conv weights for inference (1 Mb family)."""
    return dataclasses.replace(
        bundle, net=fold_params(bundle.net, decoders.net_spec(bundle.num_1d)))


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
    """Cast a bundle's (any class) float32 parameters to `dtype`
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
    """Pickle a bundle (any class) with its parameters as float32 numpy
    arrays, the form the JAX package's `zoo.save_bundle` writes; `load_bundle`
    reads both."""
    host = _map_params(bundle, lambda t: t.detach().float().cpu().numpy())
    with open(path, "wb") as f:
        pickle.dump(host, f)


def load_bundle(path: str, *, device=None, dtype: Optional[str] = None):
    """Read a bundle pickled by `save_bundle` or by the JAX package's
    `zoo.save_bundle` (see models.from_jax.load_bundle)."""
    from orca_tpu_torch.models.from_jax import load_bundle as _load

    return _load(path, device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Construction from the reference's torch statedicts
# --------------------------------------------------------------------------

_EXPECTED_FILES = {
    "h1esc": "4DNFI9GMP2J8.rebinned.mcool.expected.res4000.npy",
    "hff": "4DNFI643OYP9.rebinned.mcool.expected.res4000.npy",
    "hctnoc": "4DNFILP99QJS.HCT_auxin6h.rebinned.mcool.expected.res4000.npy",
}
_STEMS = {"h1esc": "4DNFI9GMP2J8", "hff": "4DNFI643OYP9"}


def _statedict(model_dir: str, stem: str) -> dict:
    return convert.load_statedict(
        os.path.join(model_dir, f"orca_{stem}.statedict"))


def load_32m_bundle(model_dir: str, resource_dir: str, name: str,
                    fold: bool = True, nbins: int = 8000, crop: int = 250,
                    *, device=None) -> ModelBundle:
    """A 1-32 Mb bundle ('h1esc', 'hff' or 'hctnoc') from the reference's
    statedicts: the pyramid from orca_<name>.net, the tower and the
    `Decoder_1m` head from the stage-a Net in orca_<name>.net0, one decoder
    per level from orca_<name>.d<level>. HCTnoc has a pyramid without the
    upward pass, nearest upsampling and no `Decoder_1m` head. float32 on
    `device` (None = CUDA), BatchNorm folded there when `fold`; nbins/crop
    scale the background for small test geometries."""
    device = resolve_device(device)
    up_pass = name != "hctnoc"
    upsample_mode = "bilinear" if up_pass else "nearest"
    pyramid = convert.convert_pyramid(
        _statedict(model_dir, f"{name}.net"), levels=5, up_pass=up_pass,
        device=device)
    net0_sd = _statedict(model_dir, f"{name}.net0")
    encoder = convert.convert_encoder_tower(net0_sd, device=device)
    decoder_1pt = (convert.convert_decoder1m(net0_sd, device=device)
                   if up_pass else None)
    del net0_sd
    dec = {
        level: convert.convert_decoder(
            _statedict(model_dir, f"{name}.d{level}"), device=device)
        for level in LEVELS_32M
    }
    expected_log = np.load(os.path.join(resource_dir, _EXPECTED_FILES[name]))
    normmats, epss = normmats_from_expectation(expected_log, nbins=nbins,
                                               crop=crop)
    bundle = ModelBundle(
        name=name,
        encoder=encoder,
        pyramid=pyramid,
        decoders=dec,
        decoder_1pt=decoder_1pt,
        normmats=normmats,
        epss=epss,
        upsample_mode=upsample_mode,
        pyramid_up_pass=up_pass,
    )
    return fold_bundle(bundle) if fold else bundle


def load_256m_bundle(model_dir: str, resource_dir: str, name: str,
                     fold: bool = True, *,
                     device=None) -> Model256MBundle:
    """A 32-256 Mb bundle ('h1esc' or 'hff'): the 3-level pyramid from
    orca_<name>_256m.net and its decoders from orca_<name>_256m.d<level>;
    the tower and the 5-level pyramid are the 32 Mb model's (orca_<name>.net0
    and orca_<name>.net). float32 on `device` (None = CUDA), folded there
    when `fold`."""
    device = resolve_device(device)
    pyramid = convert.convert_pyramid(
        _statedict(model_dir, f"{name}_256m.net"), levels=3, up_pass=True,
        device=device)
    encoder = convert.convert_encoder_tower(
        _statedict(model_dir, f"{name}.net0"), device=device)
    pyramid1 = convert.convert_pyramid(
        _statedict(model_dir, f"{name}.net"), levels=5, up_pass=True,
        device=device)
    dec = {
        level: convert.convert_decoder(
            _statedict(model_dir, f"{name}_256m.d{level}"), device=device)
        for level in LEVELS_256M
    }
    stem = os.path.join(resource_dir,
                        f"{_STEMS[name]}.rebinned.mcool.expected.res32000")
    cis = np.load(f"{stem}.mono.npy")
    trans = np.load(f"{stem}.trans.npy")
    bundle = Model256MBundle(
        name=f"{name}_256m",
        encoder=encoder,
        pyramid1=pyramid1,
        pyramid=pyramid,
        decoders=dec,
        background_cis=np.hstack([np.exp(cis), np.repeat(np.nan, 2000)]),
        background_trans=float(np.exp(trans)),
    )
    return fold_256m_bundle(bundle) if fold else bundle


def load_1m_bundle(model_dir: str, resource_dir: str, name: str, *,
                   device=None) -> Model1MBundle:
    """A standalone 1 Mb bundle ('h1esc': 32 tracks, 'hff': 22) from the
    stage-a Net in orca_<name>.net0, float32 on `device` (None = CUDA) and
    unfolded, as the JAX package loads it (load_resources folds it)."""
    device = resolve_device(device)
    num_1d = {"h1esc": 32, "hff": 22}[name]
    net = convert.convert_net(_statedict(model_dir, f"{name}.net0"),
                              num_1d=num_1d, device=device)
    expected_log = np.load(os.path.join(
        resource_dir, f"{_STEMS[name]}.rebinned.mcool.expected.res1000.npy"))
    normmats, epss = normmat_1m_from_expectation(expected_log)
    return Model1MBundle(name=f"{name}_1m", net=net, num_1d=num_1d,
                         normmats=normmats, epss=epss)


# --------------------------------------------------------------------------
# The multi-cell-type leukemia family
# --------------------------------------------------------------------------

_LEUKEMIA_NORMMAT_FILES = {
    # one expectation per output head, in head order
    "leukemiaA": [
        "GSE134761_TALL_all.hg38.no_filter.1000.mcool.expected.res4000.npy",
        "THP1.hg38.no_filter.1000.mcool.expected.res4000.npy",
    ],
    "leukemiaB": [
        "4DNFIXP4QG5B.mcool.rebinned.mcool.expected.res4000.npy",
        "NALM6.hg38.no_filter.1000.mcool.expected.res4000.npy",
        "GSE146901_T_ALL_NonETP.hg38.no_filter.1000.mcool.expected.res4000.npy",
        "GSE146901_T_ALL_ETP.hg38.no_filter.1000.mcool.expected.res4000.npy",
        "GSE63525_K562.hg38.no_filter.1000.mcool.expected.res4000.npy",
        "GSE63525_KBM7.hg38.no_filter.1000.mcool.expected.res4000.npy",
    ],
}


def multi_normmats_from_expectations(expected_logs, levels=LEVELS_32M,
                                     nbins: int = 8000, crop: int = 250):
    """Stacked per-head backgrounds: each level maps to a (num_2d, crop,
    crop) array, with one scalar eps (the least value) across heads."""
    idx = np.abs(np.arange(nbins)[None, :] - np.arange(nbins)[:, None])
    mats = np.stack([np.exp(e[:nbins])[idx] for e in expected_logs])
    normmats, epss = {}, {}
    for level in levels:
        n = crop * level
        r = (
            mats[:, :n, :n]
            .reshape(len(expected_logs), crop, level, crop, level)
            .mean(axis=4)
            .mean(axis=2)
        )
        normmats[level] = r
        epss[level] = float(np.min(r))
    return normmats, epss


def load_leukemia_bundle(model_dir: str, resource_dir: str, name: str,
                         fold: bool = True, *, device=None) -> ModelBundle:
    """A multi-cell-type leukemia bundle: 'leukemiaA' (2 heads) or
    'leukemiaB' (6 heads), laid out in files as the 32 Mb models are. Its
    pyramid has no upward pass, its decoders upsample nearest and take one
    distance-encoding channel and give one output channel per head. float32
    on `device` (None = CUDA), folded there when `fold`. The backgrounds take
    num_2d x 512 MB of host memory while they are built."""
    device = resolve_device(device)
    files = _LEUKEMIA_NORMMAT_FILES[name]
    num_2d = len(files)
    pyramid = convert.convert_pyramid(
        _statedict(model_dir, f"{name}.net"), levels=5, up_pass=False,
        device=device)
    net0_sd = _statedict(model_dir, f"{name}.net0")
    encoder = convert.convert_encoder_tower(net0_sd, device=device)
    decoder_1pt = convert.convert_decoder1m(net0_sd, num_2d=num_2d,
                                            device=device)
    del net0_sd
    dec = {
        level: convert.convert_decoder(
            _statedict(model_dir, f"{name}.d{level}"), num_2d=num_2d,
            device=device)
        for level in LEVELS_32M
    }
    normmats, epss = multi_normmats_from_expectations(
        [np.load(os.path.join(resource_dir, f)) for f in files])
    bundle = ModelBundle(
        name=name,
        encoder=encoder,
        pyramid=pyramid,
        decoders=dec,
        decoder_1pt=decoder_1pt,
        normmats=normmats,
        epss=epss,
        upsample_mode="nearest",
        pyramid_up_pass=False,
        num_2d=num_2d,
    )
    return fold_bundle(bundle) if fold else bundle


def random_leukemia_bundle(seed: int = 0, num_2d: int = 2,
                           name: str = "random_leukemia", nbins: int = 8000,
                           crop: int = 250, *, device=None) -> ModelBundle:
    """A leukemia-family bundle with torch's default conv init from `seed`
    (float32, BatchNorm unfolded) on `device` (None = CUDA), with the JAX
    package's smooth per-head backgrounds."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = np.arange(nbins, dtype=np.float64)
    normmats, epss = multi_normmats_from_expectations(
        [-1.5 * np.log1p(d) - 2.0 - 0.1 * i for i in range(num_2d)],
        nbins=nbins, crop=crop)
    bundle = ModelBundle(
        name=name,
        encoder=encoders.init_encoder_tower(gen),
        pyramid=encoders.init_pyramid(gen, 5, False),
        decoders={lv: decoders.init_decoder(gen, num_2d)
                  for lv in LEVELS_32M},
        decoder_1pt=decoders.init_decoder1m(gen, num_2d),
        normmats=normmats,
        epss=epss,
        upsample_mode="nearest",
        pyramid_up_pass=False,
        num_2d=num_2d,
    )
    return _map_params(bundle, lambda t: t.to(device))
