"""1 Mb window-batch requests through the port's `onemb.predict_1m`: each
request is `windows_per_request` windows of 1 Mb at independent offsets in
the run's pool of sequence (packed uint8, in host memory), gathered into
one batch and run on every model of the configuration in turn, with the
chromatin tracks and the reverse-complement average; the answer is, per
model, every window's map and then every window's tracks, as host arrays.
"""

from __future__ import annotations

import importlib
from typing import Dict

import numpy as np
import torch

from portbench import flops, flops1m, inputs
from portbench.reference import orca1m
from portbench.weights import child_seed
from portbench.weights1m import calibrate_track_head, draw_net_statedict


class Driver:
    """The request kind of the standalone 1 Mb model (the harness's driver
    contract: `portbench/README.md`)."""

    family = "1m"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        _check_steps(config.get("spans", []))
        from orca_tpu_torch.models import convert, zoo
        from orca_tpu_torch.predict import onemb

        self.onemb = onemb
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.window_bp = config["geometry"]["window_bp"]
        self.windows = traffic["windows_per_request"]
        self.num_1d = config["num_1d"]
        self.models = config["models_per_request"]
        self.pool = inputs.sequence_pool(
            child_seed(seed, 2), traffic["pool_bp"], traffic["n_fraction"],
            traffic["n_run_bp"], self.device)
        self.batch = np.empty((self.windows, self.window_bp, 4), np.uint8)
        self.bundles = []
        for m in range(self.models):
            expected = inputs.expected_log_32m(
                np.random.default_rng(child_seed(seed, 20 + m)), 1000)
            normmats, epss = zoo.normmat_1m_from_expectation(expected)
            sd = self.statedict(m)
            bundle = zoo.Model1MBundle(
                name=config["models"][m],
                net=convert.convert_net(sd, num_1d=self.num_1d[m],
                                        device=self.device),
                num_1d=self.num_1d[m], normmats=normmats, epss=epss)
            del sd
            self.bundles.append(zoo.cast_bundle(zoo.fold_1m_bundle(bundle),
                                                traffic["precision"]))
        self._reference = None

    def statedict(self, m: int):
        """Model m's `Net` statedict, drawn on the device from the seed, its
        track head's BatchNorm calibrated on the pool's first window."""
        sd = draw_net_statedict(self.num_1d[m], child_seed(self.seed, 10 + m),
                                self.device)
        window = torch.from_numpy(self.pool[None, :self.window_bp])
        calibrate_track_head(sd, self.num_1d[m], window.to(self.device))
        return sd

    def rng(self, i: int) -> np.random.Generator:
        """The draws of the run's i-th request (i < 0: warm-up requests)."""
        return np.random.default_rng(child_seed(self.seed, 100, i + 1000))

    def request(self, i: int) -> dict:
        """The i-th request: windows at independent drawn offsets."""
        top = self.traffic["pool_bp"] - self.window_bp + 1
        return {"offsets": [int(o) for o in
                            self.rng(i).integers(0, top, self.windows)]}

    def gather(self, req: dict) -> np.ndarray:
        """The request's windows as one (windows, window_bp, 4) batch, in a
        buffer the driver reuses."""
        return np.stack([self.pool[o:o + self.window_bp]
                         for o in req["offsets"]], out=self.batch)

    def call(self, req: dict):
        batch = self.gather(req)
        return [self.onemb.predict_1m(b, batch, with_1d=True, rc_average=True,
                                      device=self.device)
                for b in self.bundles]

    @staticmethod
    def answer(out) -> dict:
        """Per model its windows' maps, then its windows' tracks."""
        return {"maps": [[p[i, :, :, 0] for i in range(len(p))] + list(t)
                         for p, t in out],
                "starts": [], "ends": []}

    def mb(self, req: dict) -> float:
        return self.windows * self.window_bp / 1e6

    def length(self, req: dict) -> int:
        return self.windows * self.window_bp

    def warmup(self) -> None:
        for i in range(self.traffic.get("warmup_requests", 1)):
            self.call(self.request(-1 - i))

    def release(self) -> None:
        self.bundles = []

    def request_flops(self) -> Dict[str, int]:
        """A request's FLOPs by part: every model's tower, Decoder_1m and
        track head on the windows' forward and reverse-complement rows."""
        rows = 2 * self.windows
        bins = self.window_bp // flops.TOWER_BP
        return {"tower": self.models * flops.tower_flops(rows, self.window_bp),
                "decoder1m": self.models * flops.decoder1m_flops(rows, bins),
                "tracks": sum(flops1m.final1d_flops(rows, bins, n)
                              for n in self.num_1d[:self.models])}

    def tower_least_s(self, card: str) -> float:
        """Every model's tower over the windows' forward and
        reverse-complement rows, at its least time on `card`."""
        return self.models * flops.tower_least_seconds(
            self.window_bp, self.traffic["precision"], card,
            rows=2 * self.windows)

    def reference_models(self):
        """The reference's folded models, built once, from the statedicts
        drawn again from the seed."""
        if self._reference is None:
            self._reference = [orca1m.load(self.statedict(m), self.num_1d[m],
                                           self.device)
                               for m in range(self.models)]
        return self._reference

    def reference(self, req: dict, precision: str = "fp32") -> dict:
        packed = torch.from_numpy(self.gather(req)).to(self.device)
        maps = []
        for model in self.reference_models():
            m, t = orca1m.predict(model, packed, precision)
            maps.append(list(m) + list(t))
        return {"maps": maps, "starts": [], "ends": []}


def _check_steps(spans) -> None:
    """The configuration's spans name steps of the program that a traced run
    wraps; a program that lacks one cannot be measured in this cell, and the
    run stops before it draws anything. Without this check such a program
    would run the cell untraced and stop only in a traced run, in the
    harness's span wrapping: the cell is measured in both kinds of run or
    in neither."""
    missing = []
    for qualname in spans:
        module, name = qualname.rsplit(".", 1)
        if not hasattr(importlib.import_module(module), name):
            missing.append(qualname)
    if missing:
        raise RuntimeError("the program lacks the steps this configuration "
                           "names: " + ", ".join(missing))
