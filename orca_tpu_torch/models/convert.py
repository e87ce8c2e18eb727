"""Reference torch statedicts -> the port's parameter trees (counterpart of
orca_tpu/models/convert.py).

The reference ships its models as torch ``.statedict`` files, one per
module, with a DataParallel ``"module."`` prefix on the keys and BatchNorm
``num_batches_tracked`` buffers beside the running statistics. Every torch
nn.Sequential in them is a chain of
[Pool|Upsample]? ([Dropout]? Conv [BN]? [ReLU|Sigmoid]?)* -- the structure a
`Block` spec describes -- so the torch child indices are recomputed from the
specs instead of being hard-coded per module.

Weight layout (the port keeps the JAX package's channels-last layout):
  Conv1d (out, in, k)      -> (k, in, out)
  Conv2d (out, in, kh, kw) -> (kh, kw, in, out)
  BatchNorm weight/bias/running_mean/running_var -> scale/bias/mean/var

Each converter returns float32 tensors on `device` (None = CUDA). The
`*_statedict` functions are the inverses: a parameter tree in the port's
layout (tensors or numpy arrays, BatchNorm unfolded) as float32 CPU tensors
under the reference's keys, without the 'module.' prefix.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.nn.core import Block, Unit
from orca_tpu_torch.utils.config import resolve_device

_BN_KEYS = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
            ("var", "running_var"))


def _to_tensor(v, device: torch.device, perm=None) -> torch.Tensor:
    """A statedict entry (tensor or numpy array) as a contiguous float32
    tensor on `device`, its axes permuted by `perm` when given."""
    t = torch.as_tensor(v).detach().to(device=device, dtype=torch.float32)
    if perm is not None:
        t = t.permute(perm)
    return t.contiguous()


def strip_module_prefix(sd: Dict) -> Dict:
    """Drop DataParallel's 'module.' key prefix."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def _conv_perm(unit: Unit):
    return (2, 1, 0) if unit.dim == 1 else (2, 3, 1, 0)


def _convert_unit(sd: Dict, prefix: str, idx: int, unit: Unit,
                  device: torch.device):
    """Convert one Unit starting at torch Sequential child index `idx`.

    Returns (params_dict, next_idx).
    """
    if unit.dropout > 0.0:
        idx += 1  # nn.Dropout holds no params
    p = {"w": _to_tensor(sd[f"{prefix}{idx}.weight"], device, _conv_perm(unit)),
         "b": _to_tensor(sd[f"{prefix}{idx}.bias"], device)}
    idx += 1
    if unit.bn:
        p["bn"] = {ours: _to_tensor(sd[f"{prefix}{idx}.{theirs}"], device)
                   for ours, theirs in _BN_KEYS}
        idx += 1
    if unit.relu or unit.sigmoid:
        idx += 1
    return p, idx


def convert_block(sd: Dict, prefix: str, block: Block, *,
                  device=None) -> list:
    """Convert a torch nn.Sequential at `prefix` (e.g. 'lconv1.') to Block
    params."""
    device = resolve_device(device)
    idx = 1 if (block.pool or block.upsample) else 0
    params = []
    for unit in block.units:
        p, idx = _convert_unit(sd, prefix, idx, unit, device)
        params.append(p)
    return params


def convert_encoder_tower(sd: Dict, prefix: str = "", *,
                          device=None) -> dict:
    sd = strip_module_prefix(sd)
    spec = encoders.encoder_tower_spec()
    return {
        "lconv": [
            convert_block(sd, f"{prefix}lconv{i + 1}.", b, device=device)
            for i, b in enumerate(spec["lconv"])
        ],
        "conv": [
            convert_block(sd, f"{prefix}conv{i + 1}.", b, device=device)
            for i, b in enumerate(spec["conv"])
        ],
    }


_PYRAMID_TORCH_NAMES = {
    "lblocks": "lblocks",
    "blocks": "blocks",
    "downl": "downlblocks",
    "down": "downblocks",
}


def convert_pyramid(sd: Dict, levels: int, up_pass: bool, prefix: str = "",
                    *, device=None) -> dict:
    sd = strip_module_prefix(sd)
    spec = encoders.pyramid_spec(levels, up_pass)
    return {
        name: [
            convert_block(sd, f"{prefix}{_PYRAMID_TORCH_NAMES[name]}.{i}.", b,
                          device=device)
            for i, b in enumerate(blocks)
        ]
        for name, blocks in spec.items()
    }


def _convert_2d_stack(sd: Dict, spec: dict, prefix: str, device) -> dict:
    """A decoder's modules: a Block is one nn.Sequential, a list of Blocks a
    ModuleList of them."""
    sd = strip_module_prefix(sd)
    out = {}
    for name, node in spec.items():
        if isinstance(node, Block):
            out[name] = convert_block(sd, f"{prefix}{name}.", node,
                                      device=device)
        else:
            out[name] = [
                convert_block(sd, f"{prefix}{name}.{i}.", b, device=device)
                for i, b in enumerate(node)
            ]
    return out


def convert_decoder(sd: Dict, num_2d: int = 1, prefix: str = "", *,
                    device=None) -> dict:
    return _convert_2d_stack(sd, decoders.decoder_spec(num_2d), prefix, device)


def convert_decoder1m(sd: Dict, num_2d: int = 1, prefix: str = "", *,
                      device=None) -> dict:
    return _convert_2d_stack(sd, decoders.decoder1m_spec(num_2d), prefix,
                             device)


def convert_net(sd: Dict, num_1d: Optional[int] = None, num_2d: int = 1,
                prefix: str = "", *, device=None) -> dict:
    """Convert a stage-a `Net` statedict (also the file the 32 Mb models
    carve their tower and `Decoder_1m` out of)."""
    sd = strip_module_prefix(sd)
    params = {
        "encoder": convert_encoder_tower(sd, prefix, device=device),
        "decoder": convert_decoder1m(sd, num_2d, prefix, device=device),
    }
    if num_1d:
        params["final_1d"] = convert_block(
            sd, f"{prefix}final_1d.", decoders.final1d_spec(num_1d),
            device=device
        )
    return params


def load_statedict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch .statedict file into a name -> CPU tensor dict (tensors
    only: no code runs while it loads)."""
    return torch.load(path, map_location="cpu", weights_only=True)


# --------------------------------------------------------------------------
# The inverse: parameter trees -> reference-format statedicts
# --------------------------------------------------------------------------


def _host(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32)


def block_statedict(params: list, prefix: str, block: Block) -> dict:
    """The inverse of convert_block: one nn.Sequential's entries, each
    BatchNorm with the `num_batches_tracked` buffer torch writes."""
    out = {}
    idx = 1 if (block.pool or block.upsample) else 0
    for p, unit in zip(params, block.units):
        if unit.dropout > 0.0:
            idx += 1
        perm = _conv_perm(unit)
        inv = tuple(perm.index(i) for i in range(len(perm)))
        out[f"{prefix}{idx}.weight"] = _host(p["w"]).permute(inv).contiguous()
        out[f"{prefix}{idx}.bias"] = _host(p["b"])
        idx += 1
        if unit.bn:
            for ours, theirs in _BN_KEYS:
                out[f"{prefix}{idx}.{theirs}"] = _host(p["bn"][ours])
            out[f"{prefix}{idx}.num_batches_tracked"] = torch.tensor(0)
            idx += 1
        if unit.relu or unit.sigmoid:
            idx += 1
    return out


def encoder_tower_statedict(params: dict, prefix: str = "") -> dict:
    spec = encoders.encoder_tower_spec()
    out = {}
    for name in ("lconv", "conv"):
        for i, (p, b) in enumerate(zip(params[name], spec[name])):
            out.update(block_statedict(p, f"{prefix}{name}{i + 1}.", b))
    return out


def pyramid_statedict(params: dict, levels: int, up_pass: bool,
                      prefix: str = "") -> dict:
    out = {}
    for name, blocks in encoders.pyramid_spec(levels, up_pass).items():
        for i, (p, b) in enumerate(zip(params[name], blocks)):
            out.update(block_statedict(
                p, f"{prefix}{_PYRAMID_TORCH_NAMES[name]}.{i}.", b))
    return out


def _2d_stack_statedict(params: dict, spec: dict, prefix: str) -> dict:
    out = {}
    for name, node in spec.items():
        if isinstance(node, Block):
            out.update(block_statedict(params[name], f"{prefix}{name}.", node))
        else:
            for i, (p, b) in enumerate(zip(params[name], node)):
                out.update(block_statedict(p, f"{prefix}{name}.{i}.", b))
    return out


def decoder_statedict(params: dict, num_2d: int = 1, prefix: str = "") -> dict:
    return _2d_stack_statedict(params, decoders.decoder_spec(num_2d), prefix)


def decoder1m_statedict(params: dict, num_2d: int = 1,
                        prefix: str = "") -> dict:
    return _2d_stack_statedict(params, decoders.decoder1m_spec(num_2d), prefix)


def net_statedict(params: dict, num_1d: Optional[int] = None, num_2d: int = 1,
                  prefix: str = "") -> dict:
    """A stage-a `Net`'s statedict: the tower, `Decoder_1m` and, when
    num_1d is set, the 1D track head `final_1d`."""
    out = encoder_tower_statedict(params["encoder"], prefix)
    out.update(decoder1m_statedict(params["decoder"], num_2d, prefix))
    if num_1d:
        out.update(block_statedict(params["final_1d"], f"{prefix}final_1d.",
                                   decoders.final1d_spec(num_1d)))
    return out
