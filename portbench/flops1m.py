"""Operations and bytes of the standalone 1 Mb model's heads (Orca's `Net`),
from the shapes alone, as `flops.py` counts the tower: the 1-D track head
`final_1d`, and the 2-D stack (the pairwise map and `Decoder_1m`) layer by
layer, for its least time.

A layer of the 2-D stack reads its input once, writes its output once and
reads its weights and biases once, in the precision; the pairwise map reads
the tower's output and writes the (rows, crop, crop, 128) map. Its least
time is, per layer, the larger of its FLOPs over the precision's peak and
its bytes over the memory bandwidth: at 64 -> 32 channels the stack sits
below the H100's ridge, so bytes matter.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.flops import (BLOCKS_1M, DTYPE_BYTES, PEAKS, conv1d_flops,
                             conv2d_flops, decoder1m_flops, tower_flops)

BANDWIDTH = PEAKS[""][2]  # the H100 SXM's 3.35 TB/s
# (cin, cout, k) of each convolution of Decoder_1m, in order
DECODER1M_CONVS = (((128, 32, 3), (32, 64, 3))
                   + ((64, 32, 3), (32, 64, 3)) * (2 * BLOCKS_1M - 1)
                   + ((64, 5, 1), (5, 1, 1)))


def final1d_flops(rows: int, bins: int, num_1d: int) -> int:
    """The track head over `rows` rows of `bins` positions."""
    return (conv1d_flops(rows * bins, 128, 128, k=1)
            + conv1d_flops(rows * bins, 128, num_1d, k=1))


def decoder1m_layers(rows: int, crop: int,
                     precision: str) -> List[Dict[str, int]]:
    """The 2-D stack's layers over `rows` crop x crop maps: the pairwise map,
    then each convolution of Decoder_1m, each with its `flops` and
    `bytes`."""
    size = DTYPE_BYTES[precision]
    pixels = rows * crop * crop
    out = [{"flops": 0,
            "bytes": (rows * crop * 128 + pixels * 128) * size}]
    for cin, cout, k in DECODER1M_CONVS:
        out.append({"flops": rows * conv2d_flops(crop, cin, cout, k),
                    "bytes": (pixels * (cin + cout)
                              + k * k * cin * cout + cout) * size})
    return out


def decoder1m_least_seconds(rows: int, crop: int, precision: str,
                            flop_peak: float,
                            bandwidth: float = BANDWIDTH) -> float:
    """The 2-D stack's least time over `rows` crop x crop maps."""
    return sum(max(layer["flops"] / flop_peak, layer["bytes"] / bandwidth)
               for layer in decoder1m_layers(rows, crop, precision))


def decoder1m_geometry(request_flops: Dict[str, int]):
    """(maps, crop) of a request of the standalone 1 Mb model, from the
    FLOPs its driver counts: the 2-D stack runs on the tower's output, one
    crop x crop map a tower row of crop 4 kb bins, so the tower's FLOPs
    count maps x crop and Decoder_1m's count maps x crop^2."""
    per_map_bin = tower_flops(1, 4000)
    per_pixel = decoder1m_flops(1, 1)
    map_bins = request_flops["tower"] // per_map_bin
    pixels = request_flops["decoder1m"] // per_pixel
    crop = pixels // map_bins
    return map_bins // crop, crop
