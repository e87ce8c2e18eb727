"""What the cascade drivers share: a pool of sequence in host memory that
requests cut windows from, the port's bundles built from statedicts drawn
from the seed, and the plain reference on the same statedicts."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import flops, inputs
from portbench.reference import orca
from portbench.weights import child_seed, draw_statedicts


class CascadeDriver:
    """A request kind. Each driver file's `Driver` also counts the work its
    model defines for one request, which a traced run reads:
    `request_flops()` (FLOPs by part, `portbench.flops`) and
    `tower_least_s(card)` (the encoder tower's least time)."""

    family = ""  # the reference's model family: '32m' or '256m'

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from orca_tpu_torch.predict import multiscale

        self.ms = multiscale
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.geom = dict(config["geometry"])
        self.levels = tuple(self.geom["levels"])
        self.models = config["models_per_request"]
        g = self.geom
        self.geometry = multiscale.CascadeGeometry(
            g["window_bp"], g["bin_bp"], g["crop"])
        self.pool = inputs.sequence_pool(
            child_seed(seed, 2), traffic["pool_bp"], traffic["n_fraction"],
            traffic["n_run_bp"], self.device)
        self.bundles = []
        self._reference = None

    def statedicts(self, m: int):
        """Model m's statedicts, drawn on the device from the seed."""
        return draw_statedicts(self.family, self.levels,
                               child_seed(self.seed, 10 + m), self.device)

    def rng(self, i: int) -> np.random.Generator:
        """The draws of the run's i-th request (i < 0: warm-up requests)."""
        return np.random.default_rng(child_seed(self.seed, 100, i + 1000))

    def request_flops(self) -> Dict[str, int]:
        raise NotImplementedError(
            f"{type(self).__module__} counts no FLOPs for its requests")

    def tower_least_s(self, card: str) -> float:
        """The encoder tower's least time for one request on `card`: every
        model's tower over the window's forward and reverse-complement
        rows."""
        return self.models * flops.tower_least_seconds(
            self.geom["window_bp"], self.traffic["precision"], card)

    def mb(self, req: dict) -> float:
        return self.geom["window_bp"] / 1e6

    def length(self, req: dict) -> int:
        """The request's sequence length, by which the check picks the
        longest."""
        return self.geom["window_bp"]

    def window(self, req: dict) -> np.ndarray:
        off = req["offset"]
        return self.pool[None, off:off + self.geom["window_bp"]]

    def warmup(self) -> None:
        for i in range(self.traffic.get("warmup_requests", 1)):
            self.call(self.request(-1 - i))

    def release(self) -> None:
        self.bundles = []

    def reference_models(self):
        """The reference's folded models, built once, from the statedicts
        drawn again from the seed."""
        if self._reference is None:
            self._reference = [
                orca.load(self.family, self.levels,
                                     self.statedicts(m), self.device)
                for m in range(self.models)]
        return self._reference
