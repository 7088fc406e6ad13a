"""Data-parallel training over ranks: counterpart of
``vfidkr_tpu/parallel/mesh.py``.

JAX's trainer puts every chip on one ``data`` mesh axis: the batch is
sharded on its leading dim, the state replicated, and XLA averages the
gradients.  Here the same run is one process a rank, as ``torchrun`` starts
them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address in
the environment): NCCL between cards, gloo on the CPU.  Each rank takes its
contiguous slice of every global batch (``shard_range``), the ranks start
from rank 0's weights (``replicate``), and the gradients are averaged across
ranks before the optimizer steps (``average_gradients``).  DAIN's trained
parts keep no batch statistics (MegaDepth's BN runs on its running
statistics and is frozen), so the step equals the one-process step on the
whole global batch, up to the order of the sums: each rank's loss is the
mean over its equal share.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the data-parallel ranks; ``joined``: it
    is in a process group, and the collectives run (even at world size 1)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    joined: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def create_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The mesh of this process, from the ``torchrun`` environment.  With
    ``WORLD_SIZE`` > 1 it joins the process group (NCCL for CUDA, gloo for
    the CPU) and, on CUDA, takes card ``LOCAL_RANK``; at world size 1 it
    joins nothing and keeps ``device``."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return Mesh(0, 1, device, dist.is_initialized())
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=rank, world_size=world)
    return Mesh(rank, world, device, True)


def shard_range(batch_size: int, mesh: Mesh) -> range:
    """The indices of the global batch that ``mesh.rank`` takes: a
    contiguous share of ``batch_size / world`` (which must divide)."""
    if batch_size % mesh.world:
        raise ValueError(f"the global batch {batch_size} does not divide "
                         f"into {mesh.world} ranks")
    share = batch_size // mesh.world
    return range(mesh.rank * share, (mesh.rank + 1) * share)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global batch dict, on its device."""
    rows = shard_range(next(iter(batch.values())).shape[0], mesh)
    return {k: v[rows.start:rows.stop].to(mesh.device, non_blocking=True)
            for k, v in batch.items()}


def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Every rank takes rank 0's parameters and buffers."""
    if not mesh.joined:
        return
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, 0)


def _flat_all_reduce(tensors: Sequence[torch.Tensor], world: int) -> None:
    """Replace each tensor by its mean across the ranks: one all-reduce of
    their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def average_gradients(module: torch.nn.Module, mesh: Mesh) -> None:
    """Each parameter's gradient becomes its mean across the ranks."""
    if not mesh.joined:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if grads:
        _flat_all_reduce(grads, mesh.world)


def mean_across(values: Dict[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """The mean of each (float) metric across the ranks: the global batch's
    value of a mean over equal shares."""
    if not mesh.joined:
        return values
    out = {k: v.detach().float().clone() for k, v in values.items()}
    _flat_all_reduce(list(out.values()), mesh.world)
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.joined:
        dist.barrier()
