"""Data-parallel process groups (``hoisdf_tpu/parallel/mesh.py``).

The JAX package runs one controller over a 1-D ``data`` mesh: XLA sees one
global batch sharded over the devices, with the parameters replicated.
PyTorch has no single-controller mode, so here each rank is a process (as
``torchrun`` starts them), and the global-batch semantics are made by hand:
BatchNorm all-reduces its statistics (``models/layers.py``), the losses
normalised by a data-dependent count divide by the global count
(``losses.py``), and the gradients are averaged over the ranks (DDP, ZeRO-1
or FSDP, ``train.py`` and ``parallel/zero.py``).

A :class:`Mesh` names a rank's place in the group: rank, world size, local
rank, its device and the group.  Without a group it is ``(0, 1, 0, device,
None)``, and nothing in the port calls a collective.  The JAX package's
``model`` axis has no users there and is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None  # the default process group, or None

    @property
    def distributed(self) -> bool:
        """A process group exists (possibly of one rank)."""
        return self.group is not None


def world_size() -> int:
    """The default group's size, or 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed(backend: Optional[str] = None, *, cpu: bool = False) -> None:
    """Start the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    ``backend`` defaults to "gloo" with ``cpu`` and to "nccl" otherwise.
    NCCL needs a card for each local rank; ranks that share a card (NCCL
    refuses two ranks on one device) must ask for "gloo" themselves, which
    all-reduces and broadcasts CUDA tensors and gathers host ones."""
    if dist.is_initialized():
        return
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if key not in os.environ:
            raise RuntimeError(f"init_distributed: {key} is not set; start the ranks with "
                               "torchrun (or set the variables yourself)")
    backend = backend or ("gloo" if cpu else "nccl")
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        if not torch.cuda.is_available() or torch.cuda.device_count() < local_world:
            raise RuntimeError(
                f"init_distributed: NCCL needs one card per local rank ({local_world} ranks, "
                f"{torch.cuda.device_count()} cards); pass backend='gloo' for ranks that "
                "share a card, or --cpu")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)


def make_mesh(device=None) -> Mesh:
    """This rank's :class:`Mesh`.  ``device`` defaults to ``cuda:{LOCAL_RANK}``
    (give "cpu", or a shared card, explicitly)."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(device=torch.device(device if device is not None else "cuda:0"))
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device(device if device is not None else f"cuda:{local}")
    return Mesh(dist.get_rank(), dist.get_world_size(), local, dev, dist.group.WORLD)


def rows_of(n: int, mesh: Mesh) -> slice:
    """The rank's contiguous rows of a global batch of ``n`` (``n`` a
    multiple of the world size), as ``NamedSharding(P("data"))`` places
    them."""
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} does not split over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Mapping, mesh: Mesh) -> dict:
    """The rank's rows of every array (numpy or tensor) of a global batch."""
    if not batch:
        return {}
    rows = rows_of(len(next(iter(batch.values()))), mesh)
    return {k: v[rows] for k, v in batch.items()}


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed for ``rank`` of a run seeded with ``seed``: ``seed``
    itself on rank 0 (the one-process run's), on every other rank a 32-bit
    seed drawn from ``(seed, rank)`` (torch's CPU generator keeps 32 bits of
    its seed)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum over
    the ranks of the output's gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the default group, differentiably."""
    return _AllReduceSum.apply(x)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the default group (one all-reduce)."""
    x = x.clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()
