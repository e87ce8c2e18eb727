"""Sequence-axis sharded encoder tower (counterpart of
orca_tpu/parallel/sequence.py).

The length axis is cut into one shard per device of the mesh's 'seq' axis.
Each shard is padded with its neighbours' 112 kb edges, and with zeros at
the sequence ends, then encoded on its device by the ordinary
`apply_encoder_tower` with the shard's bounds. The halo covers the tower's
receptive field (~104 kb, encoders.RECEPTIVE_FIELD_BP) and the positions
past the sequence ends are zeroed after every conv, so the result is the
one-device tower's. On a CUDA device the shard runs the fused kernels under
those per-row [vs, ve) bounds.

The host never waits between shards: the padded shards and the encodings
move with non-blocking copies, so on several cards the shards run
concurrently. The encodings are concatenated on the device of the input,
as JAX all-gathers them to a replicated array.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from orca_tpu_torch.nn import encoders
from orca_tpu_torch.parallel.mesh import Mesh
from orca_tpu_torch.utils.tree import tree_map

def _params_on(params: dict, device: torch.device, mesh: Mesh) -> dict:
    """`params` on `device`: the tree itself where it lives there, else its
    copy, made once per mesh and device and kept in `mesh.param_copies`."""
    if params["lconv"][0][0]["w"].device == device:
        return params
    key = (id(params), device)
    if key not in mesh.param_copies:
        mesh.param_copies[key] = (params, tree_map(
            lambda t: t.to(device, non_blocking=True), params))
    return mesh.param_copies[key][1]


def _halo_exchange(tiles: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Pad each shard's length axis with its neighbours' edges (zeros at
    the sequence ends): (N, L_local, C) tiles in sequence order ->
    (N, L_local + 2 * halo, C), on the tiles' device."""
    if len(tiles) > 1 and tiles[0].shape[1] < halo:
        raise ValueError(f"a shard of {tiles[0].shape[1]} positions is "
                         f"shorter than the {halo} bp halo")
    zeros = tiles[0].new_zeros((tiles[0].shape[0], halo, tiles[0].shape[2]))
    out = []
    for i, tile in enumerate(tiles):
        left = tiles[i - 1][:, -halo:] if i > 0 else zeros
        right = tiles[i + 1][:, :halo] if i + 1 < len(tiles) else zeros
        out.append(torch.cat([left, tile, right], dim=1))
    return out


def sharded_encoder_tower(
    params: dict,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "data",
    halo_bp: int = 112_000,
    block_bp: Optional[int] = None,
) -> torch.Tensor:
    """bp->4kb encoder with the length axis sharded over `seq_axis`.

    x: (N, L, 4) one-hot (uint8 quarter-scale or float) with L divisible by
    (shards * 4000), and each shard at least `halo_bp` long. Returns
    (N, L/4000, 128) on x's device, equal to `apply_encoder_tower` on x.
    The mesh's devices must be of x's device type. Rows are split over
    `batch_axis` when the batch divides evenly; otherwise every row runs on
    the first mesh row.
    """
    n_seq = mesh.shape[seq_axis]
    n, length, _ = x.shape
    if length % (n_seq * encoders.BIN_BP):
        raise ValueError(f"the sequence length {length} is not a multiple of "
                         f"{n_seq} shards x {encoders.BIN_BP} bp")
    kinds = {d.type for row in mesh.devices for d in row}
    if kinds != {x.device.type}:
        raise ValueError(f"the mesh's devices are {sorted(kinds)}, the "
                         f"input is on {x.device}")
    n_data = (mesh.shape[batch_axis]
              if batch_axis in mesh.axis_names and n % mesh.shape[batch_axis]
              == 0 else 1)
    rows = n // n_data
    local = length // n_seq
    halo_bins = halo_bp // encoders.BIN_BP
    groups = []
    for d in range(n_data):
        tiles = [x[d * rows : (d + 1) * rows, s * local : (s + 1) * local]
                 for s in range(n_seq)]
        outs = []
        for s, tile in enumerate(_halo_exchange(tiles, halo_bp)):
            index = {seq_axis: s}
            if n_data > 1:
                index[batch_axis] = d
            device = mesh.device(**index)
            # edge shards hold zeros for the missing neighbour; masked
            # execution turns that into the one-device tower's zero padding
            out = encoders.apply_encoder_tower(
                _params_on(params, device, mesh),
                tile.to(device, non_blocking=True),
                block_bp=block_bp, halo_bp=halo_bp,
                valid_start_bp=halo_bp if s == 0 else 0,
                valid_end_bp=(halo_bp + local if s == n_seq - 1
                              else local + 2 * halo_bp),
            )
            outs.append(out[:, halo_bins:-halo_bins].to(x.device,
                                                        non_blocking=True))
        groups.append(torch.cat(outs, dim=1))
    return torch.cat(groups)
