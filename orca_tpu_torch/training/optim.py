"""Optimizer and learning-rate schedule (counterpart of
orca_tpu/training/optim.py).

Every stage trains with SGD (lr 0.002, momentum 0.98) and a plateau schedule
on the validation Pearson r. Momentum is a trace, torch's buffer rule
v = mu*v + g; p -= lr*v, over a functional parameter tree; the learning rate
is passed into each step, so the host-side scheduler needs no rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orca_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with torch-style momentum; state {"trace": tree of v}."""

    momentum: float = 0.98

    def init(self, params) -> dict:
        return {"trace": tree_map(torch.zeros_like, params)}


def sgd(momentum: float = 0.98) -> SGD:
    return SGD(momentum)


def apply_sgd(opt: SGD, params, opt_state: dict, grads, lr):
    """One update: v = g + mu*v, p = p - lr*v, leaf-wise over the trees
    (the JAX package's optax.trace, in its order of operations). lr is
    rounded to float32, as the JAX package's trainers pass it. Returns
    (params, opt_state) as new trees."""
    p = tree_leaves(params)
    v = torch._foreach_add(tree_leaves(grads), torch._foreach_mul(
        tree_leaves(opt_state["trace"]), opt.momentum))
    new_p = torch._foreach_sub(p, torch._foreach_mul(v, float(np.float32(lr))))
    return (tree_unflatten(params, new_p),
            {"trace": tree_unflatten(opt_state["trace"], v)})


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics, mode='max')."""

    lr: float
    factor: float = 0.9
    patience: int = 10
    threshold: float = 0.0
    min_lr: float = 0.0
    best: Optional[float] = None
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if self.best is None or metric > self.best + self.threshold:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        """The full state: with `lr` alone a resumed run would reset the
        plateau counters and could fire a decision twice."""
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, s: dict) -> None:
        self.lr = float(s["lr"])
        self.best = None if s.get("best") is None else float(s["best"])
        self.num_bad = int(s.get("num_bad", 0))
