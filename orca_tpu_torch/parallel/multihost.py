"""Multi-process data parallelism over torch.distributed (counterpart of
orca_tpu/parallel/multihost.py).

A training mesh's 'data' axis spans processes, one process per data index,
started by `torchrun` or by `training.launch` (which spawns them as torchrun
would); its 'seq' axis stays inside a process, whose row of devices drives
the sequence-sharded encoder tower (parallel.sequence).

The semantics are the JAX package's global-batch data parallelism: every
process seeds its sampler alike and draws the same global batch, keeps its
`local_batch_slice`, and an N-process step computes what a one-process step
computes on the whole batch. Under JAX's jit every mean over a data-sharded
batch is global; here a `DataGroup` makes each one global by hand: the
BatchNorm batch statistics (nn_ops.batchnorm_train), the dropout masks,
drawn at the global shape (nn.core.apply_unit), the losses' denominators
(training.losses), the gradients and the metrics (training.stages).

Backends: nccl for CUDA, gloo for the CPU. A world of one process makes no
collective call: every function here then returns what it was given.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from orca_tpu_torch.parallel import mesh as mesh_lib
from orca_tpu_torch.utils.tree import tree_leaves, tree_unflatten

_local_rank = 0  # this process's index on its host, set by initialize


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group. Arguments left out are read from torchrun's
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK;
    the local rank defaults to the process id). backend: None = nccl when
    CUDA is available, else gloo. With nccl, the local rank's card is made
    current first. Idempotent: a second call is a no-op. Raises when the
    rendezvous fails; never falls back to one process."""
    global _local_rank
    if dist.is_initialized():
        return
    env = os.environ
    try:
        address = coordinator_address or (
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}")
        world = int(num_processes if num_processes is not None
                    else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise RuntimeError(
            f"multihost.initialize needs {e.args[0]} (as torchrun sets it) "
            "or explicit arguments") from None
    local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    _local_rank = local_rank


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


class _AllSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the gradient over them
    too (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, t, process_group):
        ctx.process_group = process_group
        out = t.clone()
        dist.all_reduce(out, group=process_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.process_group)
        return grad, None


class DataGroup:
    """The processes that split one global batch along its first axis, each
    holding an equal share of rows. The collectives are called in the same
    order on every rank: the ranks run the same code on equal shapes, and
    draw the same keys."""

    def __init__(self, world: int, rank: int, process_group=None):
        self.world, self.rank, self.process_group = world, rank, process_group

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over ranks, differentiable."""
        return _AllSum.apply(t, self.process_group)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over ranks in place, outside autograd."""
        dist.all_reduce(t, group=self.process_group)
        return t

    def _flat_apply(self, tree, op):
        """op(buffer) on one flat buffer per dtype of the tree's tensor
        leaves; returns a tree of new tensors (non-tensor leaves kept)."""
        leaves = tree_leaves(tree)
        out = list(leaves)
        by_dtype = {}
        for i, t in enumerate(leaves):
            if isinstance(t, torch.Tensor):
                by_dtype.setdefault((t.dtype, t.device), []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
            op(flat)
            for i, piece in zip(idx, flat.split([leaves[i].numel()
                                                 for i in idx])):
                out[i] = piece.view_as(leaves[i])
        return tree_unflatten(tree, out)

    def sum_tree(self, tree):
        """The tree summed over ranks, one collective per dtype."""
        return self._flat_apply(tree, self.sum_)

    def broadcast_tree(self, tree, src: int = 0):
        """Rank `src`'s tree on every rank, one collective per dtype."""
        return self._flat_apply(tree, lambda t: dist.broadcast(
            t, src, group=self.process_group))

    def min_(self, t: torch.Tensor) -> torch.Tensor:
        """The least over ranks in place, outside autograd."""
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.process_group)
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.process_group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Equal-size pieces of every rank, concatenated along the first
        axis in rank order."""
        t = t.contiguous()
        pieces = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(pieces, t, group=self.process_group)
        return torch.cat(pieces)

    def digest(self, tree) -> torch.Tensor:
        """An exact checksum of the tree's bits on this rank: (Σ bits,
        Σ bits · position) over its tensor leaves, as int64."""
        total = torch.zeros(2, dtype=torch.int64)
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            bits = t.detach().reshape(-1)
            bits = bits.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                              1: torch.uint8}[bits.element_size()])
            bits = bits.to(torch.int64)
            pos = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
            total += torch.stack([bits.sum(), (bits * pos).sum()]).cpu()
        return total

    def check_replicas(self, tree, what: str) -> None:
        """Raise unless every rank holds the same bits of `tree`."""
        digests = self.gather(self.digest(tree)[None].to(self._device(tree)))
        if not bool((digests == digests[0]).all()):
            raise RuntimeError(f"{what} differ across the data-parallel "
                               f"ranks: digests {digests.tolist()}")

    @staticmethod
    def _device(tree) -> torch.device:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                return t.device
        return torch.device("cpu")


def make_multihost_mesh(seq_per_host: int = 1,
                        axis_names: Tuple[str, str] = ("data", "seq"),
                        device_type: str = "cuda") -> mesh_lib.Mesh:
    """This process's row of a (data, seq) mesh whose 'data' axis is the
    process group: cuda:[local_rank·M, (local_rank+1)·M) for M =
    `seq_per_host` (raises when the host has too few cards), or the CPU
    named M times. The row's first card is made current."""
    devices = mesh_lib.local_devices(device_type)
    m = int(seq_per_host)
    if device_type == "cpu":
        row = devices[:1] * m
    else:
        first = _local_rank * m
        if len(devices) < first + m:
            raise ValueError(
                f"local rank {_local_rank} with seq={m} needs cuda:{first}.."
                f"cuda:{first + m - 1}; this host has {len(devices)} CUDA "
                "devices")
        row = devices[first:first + m]
        torch.cuda.set_device(row[0])
    world = process_count()
    group = DataGroup(world, process_index()) if world > 1 else None
    return mesh_lib.Mesh((tuple(row),), tuple(axis_names), data_group=group)


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process feeds."""
    pc = process_count()
    if global_batch % pc:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"over {pc} processes")
    per = global_batch // pc
    start = process_index() * per
    return slice(start, start + per)


def shard_batch(mesh: mesh_lib.Mesh, *arrays, global_batch: bool = True):
    """numpy batches -> this process's rows as tensors on its first device.

    global_batch=True (the trainer path): every process passes the same
    global batch and keeps its local_batch_slice, so an N-process run sees
    the one-process run's batch. global_batch=False: each process passes
    its own rows."""
    device = mesh.device()
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        if global_batch and mesh.data_group is not None:
            arr = arr[local_batch_slice(arr.shape[0])]
        out.append(torch.as_tensor(np.ascontiguousarray(arr)).to(device))
    return out[0] if len(out) == 1 else tuple(out)


def fetch_global(t: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None
                 ) -> np.ndarray:
    """A data-sharded tensor's global value on the host: every rank's rows
    in rank order (small validation metrics)."""
    group = mesh.data_group if mesh is not None else None
    if group is not None:
        t = group.gather(t)
    return t.detach().cpu().numpy()
