"""Every random draw of a training step goes through this module.

The JAX package threads `jax.random` keys through its steps; here a key is a
plain Python int, split and consumed by the functions below, so a step's
draws are a pure function of its key, as they are in JAX:

  * `coin`: the stage-a reverse-complement flip;
  * `bernoulli`: the dropout masks (drawn on the activation's device);
  * `randint`: the stage-b/c random zoom offsets.

Threefry draws cannot be matched bit for bit, so the same key gives other
values than JAX's; tests that compare the two packages pin both sides' draws
to the same values. A mask is drawn from a fresh `torch.Generator` seeded
from its key, never from a generator shared across draws, so a forward
recomputed under `torch.utils.checkpoint` draws the same mask again.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def key(seed: int) -> int:
    """The key of an integer seed (the counterpart of jax.random.PRNGKey)."""
    state = np.random.SeedSequence(int(seed)).generate_state(1, np.uint64)
    return int(state[0])


def split(k: int, n: int = 2) -> List[int]:
    """`n` new keys from key `k` (the counterpart of jax.random.split)."""
    state = np.random.SeedSequence([int(k) & 0xFFFFFFFF, int(k) >> 32])
    return [int(v) for v in state.generate_state(n, np.uint64)]


def coin(k: int) -> bool:
    """A fair coin flip, on the host."""
    return bool(np.random.default_rng(int(k)).random() < 0.5)


def randint(k: int, low: int, high: int) -> int:
    """A uniform integer in [low, high), on the host."""
    return int(np.random.default_rng(int(k)).integers(low, high))


def bernoulli(k: int, p: float, shape: Sequence[int],
              device) -> torch.Tensor:
    """A bool tensor of `shape` on `device`, each entry True with
    probability p."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(k) & _MASK63)
    return torch.rand(tuple(shape), generator=gen, device=device) < p
