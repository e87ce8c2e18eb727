"""Carry parameters across from the JAX package.

`params_from_numpy` turns a JAX parameter tree, as host numpy arrays (the
output of ``jax.tree.map(np.asarray, params)``), into the port's tensors;
`bundle_from_numpy` does the same for a whole bundle; `load_bundle` reads a
bundle pickled by the JAX package's ``zoo.save_bundle`` without importing
that package.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from orca_tpu_torch.models.zoo import Model256MBundle, ModelBundle, cast_bundle
from orca_tpu_torch.utils.config import get_config, resolve_device

# the JAX package's bundle classes the pickle loader maps onto the port's
_JAX_BUNDLES = {
    ("orca_tpu.models.zoo", "ModelBundle"): ModelBundle,
    ("orca_tpu.models.zoo", "Model256MBundle"): Model256MBundle,
}


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict/list/tuple of numpy arrays -> the same nesting of tensors
    on `device` (None = CUDA), cast to `dtype` when given."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind != "f" or arr.dtype.itemsize not in (4, 8):
        raise ValueError(
            f"unsupported parameter dtype {arr.dtype}: carry float32 arrays "
            "across and cast with torch"
        )
    return torch.tensor(arr, device=device, dtype=dtype or torch.float32)


def bundle_from_numpy(host, device=None, dtype: Optional[torch.dtype] = None):
    """A JAX-package ModelBundle or Model256MBundle (or one unpickled into
    the port's class) with numpy leaves -> the port's bundle of the same
    kind on `device`."""
    device = resolve_device(device)

    def conv(tree):
        return None if tree is None else params_from_numpy(tree, device, dtype)

    if hasattr(host, "pyramid1"):
        return Model256MBundle(
            name=host.name,
            encoder=conv(host.encoder),
            pyramid1=conv(host.pyramid1),
            pyramid=conv(host.pyramid),
            decoders={int(lv): conv(p) for lv, p in host.decoders.items()},
            background_cis=np.asarray(host.background_cis),
            background_trans=float(host.background_trans),
            upsample_mode=host.upsample_mode,
        )
    return ModelBundle(
        name=host.name,
        encoder=conv(host.encoder),
        pyramid=conv(host.pyramid),
        decoders={int(lv): conv(p) for lv, p in host.decoders.items()},
        decoder_1pt=conv(host.decoder_1pt),
        normmats={int(lv): np.asarray(m) for lv, m in host.normmats.items()},
        epss={int(lv): float(e) for lv, e in host.epss.items()},
        upsample_mode=host.upsample_mode,
        pyramid_up_pass=host.pyramid_up_pass,
        num_2d=host.num_2d,
    )


class _BundleUnpickler(pickle.Unpickler):
    """Maps the JAX package's bundle classes onto the port's, so loading
    never imports the JAX package."""

    def find_class(self, module, name):
        if (module, name) in _JAX_BUNDLES:
            return _JAX_BUNDLES[(module, name)]
        if module.split(".")[0] == "ml_dtypes":
            raise ValueError(
                "this bundle was pickled after a bfloat16 cast (ml_dtypes "
                "arrays); pickle the float32 bundle and pass dtype='bfloat16' "
                "to load_bundle"
            )
        if module.split(".")[0] in ("orca_tpu", "jax", "jaxlib"):
            raise ValueError(f"unsupported class in bundle pickle: {module}.{name}")
        return super().find_class(module, name)


def load_bundle(path: str, device=None, dtype: Optional[str] = None):
    """Read a float32 bundle (32 Mb or 256 Mb) written by the JAX package's
    `zoo.save_bundle` or the port's onto `device` (None = CUDA), cast to
    `dtype` (default: the config's
    param_dtype). Only load pickles this project wrote: unpickling runs
    code."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        host = _BundleUnpickler(f).load()
    bundle = bundle_from_numpy(host, device)
    return cast_bundle(bundle, dtype or get_config().param_dtype)
