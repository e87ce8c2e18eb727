"""Device meshes of the port (counterpart of orca_tpu/parallel/mesh.py).

A mesh is a (data, seq) grid of torch devices driven by this one process,
as JAX's single controller drives its devices:
  * 'data' — rows of a batch, one group of rows per mesh row;
  * 'seq'  — the bp-resolution encoder's length axis, cut into shards with
             halos (orca_tpu_torch.parallel.sequence).

A grid may name one device more than once: `[torch.device("cpu")] * 4` runs
a (1, 4) mesh on the CPU, `[cuda:0] * 2` a (1, 2) mesh on one card. Such a
mesh computes what a mesh of distinct cards computes, one shard after
another.

A training mesh's 'data' axis may span processes
(parallel.multihost.make_multihost_mesh): this process then holds one row
of the grid, and the mesh's `data_group` (the process group, its world
size and this rank) joins the rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from orca_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices: `devices[i][j]` sits at index i of the first axis
    and j of the second; `shape[name]` is an axis's size.

    param_copies: parameter trees copied to the mesh's devices, keyed by
    (id(tree), device); each entry holds its tree, so the id is not reused
    while the mesh lives (filled by parallel.sequence).
    data_group: None for a mesh of this process alone; else the
    multihost.DataGroup whose ranks each hold one row, and the first axis
    counts the rows of every rank."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str]
    param_copies: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)
    data_group: Optional[object] = dataclasses.field(default=None,
                                                     compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        world = self.data_group.world if self.data_group is not None else 1
        return dict(zip(self.axis_names,
                        (world * len(self.devices), len(self.devices[0]))))

    def local(self) -> "Mesh":
        """The rows this process drives, as a mesh of its own (sharing its
        parameter copies)."""
        return dataclasses.replace(self, data_group=None)

    def device(self, **index: int) -> torch.device:
        """The device at the given index of each named axis (0 for an axis
        not named)."""
        row = self.devices[index.get(self.axis_names[0], 0)]
        return row[index.get(self.axis_names[1], 0)]


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every device of `device_type` that this process drives, each once:
    the CUDA cards (raises without CUDA; never falls back to the CPU), or
    the one CPU device."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device(device_type)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _normalized(device) -> torch.device:
    """A CUDA device with its index (the current card when none is given),
    so a mesh compares equal to the device its parameters live on."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(axis_sizes: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None,
              axis_names: Tuple[str, str] = ("data", "seq")) -> Mesh:
    """Create a (data, seq) mesh over `devices` (default: every CUDA card).

    axis_sizes: explicit (data, seq) factorization; by default all devices go
    to 'data' (seq=1), the right default for variant-screening throughput,
    while long-context encoding can ask for seq>1.
    """
    devices = [_normalized(d) for d in (
        devices if devices is not None else local_devices())]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n, 1)
    need = axis_sizes[0] * axis_sizes[1]
    if need > n:
        raise ValueError(f"{axis_sizes} needs {need} devices, have {n}")
    cols = axis_sizes[1]
    grid = tuple(tuple(devices[i * cols : (i + 1) * cols])
                 for i in range(axis_sizes[0]))
    return Mesh(grid, tuple(axis_names))


# Default mesh for inference cascades: when set, genomepredict /
# genomepredict_256mb run the encoder sequence-sharded over its 'seq' axis
# without every process_* caller having to thread a mesh argument.
_INFERENCE_MESH: Optional[Mesh] = None


def set_inference_mesh(mesh: Optional[Mesh]) -> None:
    """Set (or clear, with None) the process-wide inference mesh."""
    global _INFERENCE_MESH
    _INFERENCE_MESH = mesh


def get_inference_mesh() -> Optional[Mesh]:
    return _INFERENCE_MESH


def inference_mesh_from_seq_shards(seq_shards: int, *,
                                   device_type: str = "cuda") -> Mesh:
    """All-devices mesh with `seq_shards` sequence shards (the remaining
    devices go to 'data' for batched window screening); `device_type` "cpu"
    builds it over the one CPU device."""
    devices = local_devices(device_type)
    n = len(devices)
    if n % seq_shards:
        raise ValueError(f"{seq_shards=} does not divide {n} devices")
    return make_mesh((n // seq_shards, seq_shards), devices=devices)
