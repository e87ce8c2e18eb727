"""256 Mb whole-chromosome prediction requests through the port's
`genomepredict_256mb`: each request is one chromosome of the traffic mix's
cycle, padded to the 256 Mb window with sequence of another chromosome, cut
from the run's pool (packed uint8, in host memory), with the region
mosaic's background made in set-up and a zoom position drawn inside the
chromosome; the answer is every level map and returned background of every
model and the start and end coordinates.
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
    family = "256m"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from orca_tpu_torch.models import convert, zoo

        super().__init__(config, traffic, seed, device)
        g = self.geom
        bins = g["window_bp"] // g["bin_bp"]
        bg = traffic["background"]
        self.mosaics = []  # [model][chromosome]
        for m in range(self.models):
            cis, trans = inputs.background_256m(
                np.random.default_rng(child_seed(seed, 20 + m)),
                bg["finite_bins"], bg["total_bins"])
            self.mosaics.append([
                inputs.mosaic_background(self._regions(c), cis, trans,
                                         g["bin_bp"])
                for c in range(len(traffic["chromosomes"]))])
            if self.mosaics[m][0].shape != (bins, bins):
                raise ValueError(f"mosaic {self.mosaics[m][0].shape} is not "
                                 f"the window's {bins} bins")
            sds = self.statedicts(m)
            bundle = zoo.Model256MBundle(
                name=config["models"][m],
                encoder=convert.convert_encoder_tower(sds["net0"],
                                                      device=self.device),
                pyramid1=convert.convert_pyramid(sds["net"], levels=5,
                                                 up_pass=True,
                                                 device=self.device),
                pyramid=convert.convert_pyramid(sds["256m.net"], levels=3,
                                                up_pass=True,
                                                device=self.device),
                decoders={lv: convert.convert_decoder(sds[f"256m.d{lv}"],
                                                      device=self.device)
                          for lv in self.levels},
                background_cis=cis, background_trans=trans)
            del sds
            self.bundles.append(zoo.cast_bundle(zoo.fold_256m_bundle(bundle),
                                                traffic["precision"]))
        self.first = int(np.random.default_rng(child_seed(seed, 3)).integers(
            len(traffic["chromosomes"])))

    def _chrlen(self, c: int) -> int:
        """The chromosome's length, rounded down to whole bins."""
        bp = self.traffic["chromosomes"][c][1]
        return bp // self.geom["bin_bp"] * self.geom["bin_bp"]

    def _regions(self, c: int):
        chrom = self.traffic["chromosomes"][c][0]
        chrlen = self._chrlen(c)
        return [(chrom, 0, chrlen),
                (self.traffic["padding_chr"], 0,
                 self.geom["window_bp"] - chrlen)]

    def request(self, i: int) -> dict:
        """The i-th request: the mix's chromosomes in a cycle from a drawn
        first one, a window at a drawn offset in the pool, zoomed at a
        position drawn inside the chromosome."""
        rng = self.rng(i)
        c = (self.first + i) % len(self.traffic["chromosomes"])
        window = self.geom["window_bp"]
        chrlen = self._chrlen(c)
        return {"chrom": c, "chrlen": chrlen,
                "offset": int(rng.integers(0, self.traffic["pool_bp"]
                                           - window + 1)),
                "wpos": window // 2,
                "mpos": int(rng.integers(0, chrlen))}

    def length(self, req: dict) -> int:
        return req["chrlen"]

    def request_flops(self) -> Dict[str, int]:
        """A request's FLOPs by part: every model's tower over the 256 Mb
        window, the 5-level pyramid at 4 kb and the 3-level one at 128 kb,
        and the decoder levels, on the forward and reverse-complement
        rows."""
        rows, g = 2, self.geom
        bins = g["window_bp"] // flops.TOWER_BP
        decoders = sum(flops.decoder_flops(rows, g["crop"], j > 0)
                       for j in range(len(self.levels)))
        tower = flops.tower_flops(rows, g["window_bp"])
        pyramid = (flops.pyramid_flops(rows, bins, 5)
                   + flops.pyramid_flops(rows, bins // 32, 3))
        return {"tower": self.models * tower,
                "pyramid": self.models * pyramid,
                "decoders": self.models * decoders}

    def call(self, req: dict):
        c = req["chrom"]
        return self.ms.genomepredict_256mb(
            self.window(req), self.traffic["chromosomes"][c][0],
            [self.mosaics[m][c] for m in range(self.models)], req["chrlen"],
            req["mpos"], req["wpos"], self.bundles,
            padding_chr=self.traffic["padding_chr"], geometry=self.geometry,
            device=self.device)

    def answer(self, out: dict) -> dict:
        levels = sorted(self.levels, reverse=True)
        return {"maps": out["predictions"], "starts": out["start_coords"],
                "ends": out["end_coords"],
                "backgrounds": [[nm[lv] for lv in levels]
                                for nm in out["normmats"]]}

    def reference(self, req: dict, precision: str = "fp32") -> dict:
        fwd = orca.Forward(precision)
        packed = torch.from_numpy(self.window(req)).to(self.device)
        maps, bgs, starts, ends = [], [], None, None
        for m, model in enumerate(self.reference_models()):
            lv_maps, lv_bgs, starts, ends = orca.cascade_256m(
                model, packed, req["mpos"], req["wpos"], req["chrlen"],
                self.mosaics[m][req["chrom"]], self.geom, fwd)
            maps.append(lv_maps)
            bgs.append(lv_bgs)
        return {"maps": maps, "backgrounds": bgs, "starts": starts,
                "ends": ends}
