"""32 Mb zoom-scan requests through the port's `genomepredict`: as
`predict32m`, but `group_requests` consecutive requests share one window,
each zoomed at its own position drawn within `zoom_bp` of the window's
centre (a user zooming into several loci of one region). The port encodes
the window again for each of them.
"""

from __future__ import annotations

import numpy as np

from portbench.drivers import predict32m
from portbench.weights import child_seed


class Driver(predict32m.Driver):

    def request(self, i: int) -> dict:
        """The i-th request: the window of group i // group_requests, at an
        offset drawn from the group's seed, zoomed at a position drawn from
        the request's."""
        group = i // self.traffic["group_requests"]
        window = self.geom["window_bp"]
        off = int(np.random.default_rng(child_seed(self.seed, 101,
                                                   group + 1000)).integers(
            0, self.traffic["pool_bp"] - window + 1))
        wpos = off + window // 2
        zoom = self.traffic["zoom_bp"]
        return {"offset": off, "wpos": wpos,
                "mpos": wpos + int(self.rng(i).integers(-zoom, zoom + 1))}
