"""Operations and bytes that the Orca models define for one request, from
the shapes alone: 2 x multiply-adds of every convolution over the window's
forward and reverse-complement rows, at the positions the model defines
(no halo, tile or padding that an implementation adds). Elementwise work
(bias, ReLU, residual adds, pooling) is not counted.

Bytes are counted for the encoder tower's stages, the roofline's unit: a
stage reads its input once (after its own pool) and writes its output once
(after the next stage's pool, the least any implementation must write), and
reads its weights once.
"""

from __future__ import annotations

from typing import Dict, List

TOWER = ((4, 64, 0), (64, 96, 4), (96, 128, 4), (128, 128, 5), (128, 128, 5),
         (128, 128, 5), (128, 128, 2))
K1 = 9  # 1D kernel size
TOWER_BP = 4000  # the tower's output bin: the product of its pools
BLOCKS_DECODER = 28
BLOCKS_1M = 19
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

# Published dense peaks (NVIDIA data sheets): (bf16 FLOP/s, fp32 FLOP/s on
# the CUDA cores, memory bytes/s), keyed by a substring of the card's name;
# the empty key is the H100 SXM.
PEAKS = {
    "PCIe": (756e12, 51e12, 2.0e12),
    "NVL": (835e12, 60e12, 3.9e12),
    "": (989e12, 67e12, 3.35e12),
}


def peaks(card_name: str):
    """(bf16 FLOP/s, fp32 FLOP/s, bytes/s) of the card."""
    for key, value in PEAKS.items():
        if key and key in card_name:
            return value
    return PEAKS[""]


def peak_flops(card_name: str, precision: str) -> float:
    bf16, fp32, _ = peaks(card_name)
    return bf16 if precision == "bfloat16" else fp32


def conv1d_flops(positions: int, cin: int, cout: int, k: int = K1) -> int:
    return 2 * positions * k * cin * cout


def conv2d_flops(side: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * side * side * k * k * cin * cout


def tower_stages(rows: int, window_bp: int,
                 precision: str) -> List[Dict[str, int]]:
    """Per stage of the encoder tower: its `flops` and `bytes` over `rows`
    rows of `window_bp`; the input of stage 0 is the packed uint8 one-hot
    (4 bytes a bp)."""
    size = DTYPE_BYTES[precision]
    pools = [p or 1 for _, _, p in TOWER] + [1]
    out, res = [], 1
    for i, (cin, cout, _) in enumerate(TOWER):
        res *= pools[i]
        positions = rows * (window_bp // res)
        flops = (conv1d_flops(positions, cin, cout)
                 + 3 * conv1d_flops(positions, cout, cout))
        in_bytes = positions * cin * (1 if i == 0 else size)
        out_bytes = rows * (window_bp // (res * pools[i + 1])) * cout * size
        w_bytes = K1 * (cin * cout + 3 * cout * cout) * size
        out.append({"flops": flops, "bytes": in_bytes + out_bytes + w_bytes})
    return out


def tower_flops(rows: int, window_bp: int) -> int:
    return sum(s["flops"] for s in tower_stages(rows, window_bp, "float32"))


def pyramid_flops(rows: int, bins: int, levels: int) -> int:
    """A pyramid with its upward pass over `bins` input positions: a level
    is 4 convs of 128 -> 128 on the way down (at bins / 2^(i+1)) and 4 on
    the way up (at the resolution it returns to)."""
    total = 0
    for i in range(levels):
        total += 4 * conv1d_flops(rows * (bins >> (i + 1)), 128, 128)
        total += 4 * conv1d_flops(rows * (bins >> (levels - 1 - i)), 128, 128)
    return total


def decoder_flops(rows: int, crop: int, coarse: bool) -> int:
    """One level's Decoder on `rows` crop x crop maps; with a coarse map
    the combiner pair replaces the first dilated block."""
    f = conv2d_flops(crop, 129, 64) + 3 * conv2d_flops(crop, 64, 64)
    blocks = 2 * BLOCKS_DECODER
    if coarse:
        f += conv2d_flops(crop, 65, 64) + 3 * conv2d_flops(crop, 64, 64)
        blocks -= 1
    f += blocks * (conv2d_flops(crop, 64, 32) + conv2d_flops(crop, 32, 64))
    f += conv2d_flops(crop, 64, 5, k=1) + conv2d_flops(crop, 5, 1, k=1)
    return rows * f


def decoder1m_flops(rows: int, crop: int) -> int:
    f = conv2d_flops(crop, 128, 32) + conv2d_flops(crop, 32, 64)
    f += (2 * BLOCKS_1M - 1) * (conv2d_flops(crop, 64, 32)
                                + conv2d_flops(crop, 32, 64))
    f += conv2d_flops(crop, 64, 5, k=1) + conv2d_flops(crop, 5, 1, k=1)
    return rows * f


def tower_least_seconds(window_bp: int, precision: str, card_name: str,
                        rows: int = 2) -> float:
    """The encoder tower's least time over `rows` rows of `window_bp`: per
    stage the larger of its FLOPs over the precision's peak and its bytes
    over the memory bandwidth, summed over stages."""
    flop_peak = peak_flops(card_name, precision)
    bw = peaks(card_name)[2]
    return sum(max(s["flops"] / flop_peak, s["bytes"] / bw)
               for s in tower_stages(rows, window_bp, precision))
