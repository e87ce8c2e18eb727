"""Stochastic weight averaging (counterpart of orca_tpu/training/swa.py):
an equal-weight running average of the parameters, updated after every
optimizer step, whose BatchNorm running statistics are refreshed by a
train-mode forward of each batch through the averaged parameters."""

from __future__ import annotations

import torch

from orca_tpu_torch.nn.core import BNUpdates, merge_bn_updates
from orca_tpu_torch.utils.tree import tree_map


def swa_init(params) -> dict:
    return {"avg": params, "n": 0}


def swa_update(swa_state: dict, params) -> dict:
    """avg <- avg + (p - avg)/(n+1), n <- n+1 (AveragedModel's default)."""
    n = int(swa_state["n"])
    avg = tree_map(lambda a, p: a + (p - a) / float(n + 1), swa_state["avg"],
                   params)
    return {"avg": avg, "n": n + 1}


def make_swa_bn_refresh(cfg, *, group=None):
    """refresh(swa_state, seq, rng) -> swa_state with the averaged
    parameters' BatchNorm running statistics updated by a train-mode forward
    of the batch (no gradient). `cfg` is a StageAConfig; group: the
    data-parallel group (global batch statistics), None for one process."""
    from orca_tpu_torch.nn import decoders
    from orca_tpu_torch.ops import nn_ops

    def refresh(swa_state, seq, rng):
        bn = BNUpdates(group=group)
        with torch.no_grad(), nn_ops.full_fp32():
            decoders.apply_net(swa_state["avg"], seq, num_1d=cfg.num_1d,
                               num_2d=getattr(cfg, "num_2d", 1), train=True,
                               rng=rng, bn_updates=bn)
        return {"avg": merge_bn_updates(swa_state["avg"], bn),
                "n": swa_state["n"]}

    return refresh


def swa_forward_update_bn(swa_state, cfg, seq, rng):
    """One-shot convenience wrapper around make_swa_bn_refresh."""
    return make_swa_bn_refresh(cfg)(swa_state, seq, rng)
