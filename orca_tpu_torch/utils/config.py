"""Configuration of the PyTorch port (counterpart of orca_tpu/utils/config.py),
holding the fields the port reads, and the device rule of the port's entry
points."""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


@dataclasses.dataclass
class OrcaConfig:
    """Framework-wide configuration.

    resource_dir: genome, expectation and micro-C resources (the reference's
        ORCA_PATH/resources); override with ORCA_TPU_RESOURCES.
    model_dir: model bundles and statedicts; override with ORCA_TPU_MODELS.
    extra_dir: chromatin-track bigWigs (the reference's ORCA_PATH/extra);
        override with ORCA_TPU_EXTRA.
    param_dtype: dtype `load_bundle` casts a bundle to by default (float32 =
        reference numerics, bfloat16 = serving precision); override with
        ORCA_TPU_PARAM_DTYPE.
    encoder_halo_bp: halo on each side of a block; 112 kb covers the tower's
        ~104 kb receptive field, so blocked and monolithic runs agree.
    kernel_block_bp: block length of the encoder tower (the counterpart of
        the JAX package's `pallas_block_bp`), a multiple of 4000.

    The first four fields take the JAX package's positions; the fields after
    them are keyword-only, because the JAX package's fifth field,
    `encoder_block_bp` (its XLA path's block), has no counterpart here, so a
    fifth positional argument raises instead of setting the halo.
    """

    resource_dir: str = os.environ.get(
        "ORCA_TPU_RESOURCES", str(REPO_ROOT / "resources")
    )
    model_dir: str = os.environ.get("ORCA_TPU_MODELS", str(REPO_ROOT / "models"))
    extra_dir: str = os.environ.get("ORCA_TPU_EXTRA", str(REPO_ROOT / "extra"))
    param_dtype: str = os.environ.get("ORCA_TPU_PARAM_DTYPE", "float32")
    _: dataclasses.KW_ONLY
    encoder_halo_bp: int = 112000
    kernel_block_bp: int = 4_000_000


_config: Optional[OrcaConfig] = None


def get_config() -> OrcaConfig:
    """The process-wide configuration: the one `set_config` installed, else
    an `OrcaConfig()` built from the environment on first use."""
    global _config
    if _config is None:
        _config = OrcaConfig()
    return _config


def set_config(config: OrcaConfig) -> None:
    """Install `config` as the process-wide configuration, e.g.
    `set_config(dataclasses.replace(get_config(), param_dtype="bfloat16"))`."""
    global _config
    _config = config


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: None means CUDA. Raises when CUDA is
    asked for and absent; never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
