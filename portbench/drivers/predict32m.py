"""32 Mb multiscale prediction requests through the port's
`genomepredict`: each request is one 32 Mb window cut from the run's pool
of sequence (packed uint8, in host memory), zoomed at a drawn position, on
every model of the configuration in turn; the answer is every level map of
every model and the start and end coordinates, as host arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import flops, inputs
from portbench.drivers._cascade import CascadeDriver
from portbench.reference import orca
from portbench.weights import child_seed


class Driver(CascadeDriver):
    family = "32m"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from orca_tpu_torch.models import convert, zoo

        super().__init__(config, traffic, seed, device)
        g = self.geom
        nbins = g["window_bp"] // g["bin_bp"]
        self.expected = []
        for m in range(self.models):
            self.expected.append(inputs.expected_log_32m(
                np.random.default_rng(child_seed(seed, 20 + m)), nbins))
            sds = self.statedicts(m)
            normmats, epss = zoo.normmats_from_expectation(
                self.expected[m], levels=self.levels, nbins=nbins,
                crop=g["crop"])
            bundle = zoo.ModelBundle(
                name=config["models"][m],
                encoder=convert.convert_encoder_tower(sds["net0"],
                                                      device=self.device),
                pyramid=convert.convert_pyramid(sds["net"], levels=5,
                                                up_pass=True,
                                                device=self.device),
                decoders={lv: convert.convert_decoder(sds[f"d{lv}"],
                                                      device=self.device)
                          for lv in self.levels},
                decoder_1pt=convert.convert_decoder1m(sds["net0"],
                                                      device=self.device),
                normmats=normmats, epss=epss)
            del sds
            self.bundles.append(zoo.cast_bundle(zoo.fold_bundle(bundle),
                                                traffic["precision"]))

    def request(self, i: int) -> dict:
        """The i-th request: a window at a drawn offset in the pool, zoomed
        at a position drawn within `zoom_bp` of its centre."""
        rng = self.rng(i)
        window = self.geom["window_bp"]
        off = int(rng.integers(0, self.traffic["pool_bp"] - window + 1))
        wpos = off + window // 2
        zoom = self.traffic["zoom_bp"]
        return {"offset": off, "wpos": wpos,
                "mpos": wpos + int(rng.integers(-zoom, zoom + 1))}

    def request_flops(self) -> Dict[str, int]:
        """A request's FLOPs by part: every model's tower, 5-level pyramid,
        decoder levels and 1 Mb head on the forward and reverse-complement
        rows."""
        rows, g = 2, self.geom
        decoders = sum(flops.decoder_flops(rows, g["crop"], j > 0)
                       for j in range(len(self.levels)))
        decoders += flops.decoder1m_flops(rows, g["crop"])
        tower = flops.tower_flops(rows, g["window_bp"])
        pyramid = flops.pyramid_flops(rows, g["window_bp"] // flops.TOWER_BP,
                                      5)
        return {"tower": self.models * tower,
                "pyramid": self.models * pyramid,
                "decoders": self.models * decoders}

    def call(self, req: dict):
        return self.ms.genomepredict(
            self.window(req), "chrPool", req["mpos"], req["wpos"],
            self.bundles, geometry=self.geometry, device=self.device)

    @staticmethod
    def answer(out: dict) -> dict:
        return {"maps": out["predictions"], "starts": out["start_coords"],
                "ends": out["end_coords"]}

    def reference(self, req: dict, precision: str = "fp32") -> dict:
        fwd = orca.Forward(precision)
        packed = torch.from_numpy(self.window(req)).to(self.device)
        maps, starts, ends = [], None, None
        for m, model in enumerate(self.reference_models()):
            lv_maps, starts, ends = orca.cascade_32m(
                model, packed, req["mpos"], req["wpos"], self.expected[m],
                self.geom, fwd)
            maps.append(lv_maps)
        return {"maps": maps, "starts": starts, "ends": ends}
