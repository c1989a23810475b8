"""DDP, ZeRO-1 and FSDP train states over the data-parallel group
(``hoisdf_tpu/parallel/zero.py``).

Memory per rank on N ranks (P the parameters' bytes):

* DDP (``--zero off``): P parameters + 2P moments (+ P gradients).
* ZeRO-1 (``zero1``): P parameters + about 2P/N moments.
  ``ZeroRedundancyOptimizer`` gives each rank whole parameters, about 1/N
  of them by size, steps the port's AdamW on those alone and broadcasts
  them; the model stays in DDP.
* FSDP (``fsdp``): about P/N parameters + 2P/N moments.  FSDP2's
  ``fully_shard`` shards every parameter on its first dimension, unit by
  unit (the backbone's four stages, the pyramid decoder, the two SDF
  decoders, the two transformers, and the rest at the root); a unit's
  parameters are gathered for its forward and backward and its gradients
  reduce-scattered.

The JAX package's rule (shard the largest divisible dimension) is a GSPMD
layout and is not copied.  Both modes compute the replicated step: the
AdamW update is elementwise, so only the order of the gradient reductions
differs.

Snapshots (``utils/checkpoint.py``) are gathered whole onto rank 0
(:func:`full_state_dicts`) in the one-process layout, and any snapshot loads
into any mode at any world size (:func:`load_full_state`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from hoisdf_torch.parallel.mesh import Mesh


def replicate(model: nn.Module, mesh: Mesh) -> nn.parallel.DistributedDataParallel:
    """``model`` (on ``mesh.device``) in DDP.  The buffers are not
    broadcast: BN's statistics are the global batch's on every rank, so they
    stay equal.  Unused parameters are looked for only under
    ``classifier_branch``, whose object classifier head no loss reads, in
    either branch; every other parameter takes a gradient in both
    (``tests/test_torch_parallel.py``)."""
    dev = mesh.device
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=model.cfg.classifier_branch)


def fsdp_units(model: nn.Module):
    """The submodules FSDP shards as units of their own, before the root."""
    resnet = model.backbone_net["resnet"]
    return [resnet.layer1, resnet.layer2, resnet.layer3, resnet.layer4,
            model.decoder_net["resnet_decoder"], model.hand_sdf_decoder,
            model.obj_sdf_decoder, model.hand_transformer, model.obj_transformer]


def shard_state(state, mesh: Mesh, *, shard_params: bool = False):
    """A one-process ``train.TrainState`` (its model on ``mesh.device``)
    made data parallel: ZeRO-1 (DDP, and the optimizer's moments sharded),
    or with ``shard_params`` FSDP (the parameters sharded too, and a new
    AdamW over the shards).  The optimizer must not have stepped yet; load a
    snapshot after this (``utils/checkpoint.py``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from hoisdf_torch.train import make_optimizer

    if state.optimizer.state:
        raise ValueError("shard_state takes a state whose optimizer has not stepped")
    model, opt = state.model, state.optimizer
    if shard_params:
        dmesh = init_device_mesh(mesh.device.type, (mesh.world,))
        for unit in fsdp_units(model):
            fully_shard(unit, mesh=dmesh)
        fully_shard(model, mesh=dmesh)
        optimizer = make_optimizer(model.cfg, model)
        optimizer.param_groups[0]["lr"] = opt.param_groups[0]["lr"]
    else:
        group = opt.param_groups[0]
        optimizer = ZeroRedundancyOptimizer(
            group["params"], optimizer_class=type(opt),
            **{k: group[k] for k in ("lr", "betas", "eps", "weight_decay")})
        model = replicate(model, mesh)
    return type(state)(model, optimizer, state.steps_per_epoch, state.step, mesh,
                       "fsdp" if shard_params else "zero1")


def _is_fsdp(module: nn.Module) -> bool:
    if not (dist.is_available() and dist.is_initialized()):
        return False
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


@contextlib.contextmanager
def unsharded(*modules: nn.Module) -> Iterator[None]:
    """Within it, the FSDP-sharded ones of ``modules`` hold their whole
    parameters, for code that reads them outside the module's own forward
    (the sampler folds an SDF decoder's weights for the kernel).  Every rank
    must enter it together; a no-op for modules that FSDP does not shard."""
    sharded = [m for m in modules if _is_fsdp(m)]
    for m in sharded:
        m.unshard()
    try:
        yield
    finally:
        for m in sharded:
            m.reshard()


def _group_of(mesh_or_group):
    """The process group of a ``Mesh``, a 1-D ``DeviceMesh`` or a group."""
    if isinstance(mesh_or_group, Mesh):
        return mesh_or_group.group
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group()
    return mesh_or_group


def gather_full(t, mesh_or_group=None, name: str = "tensor"):
    """``t`` whole on every rank: a DTensor placed ``(Shard(0),)`` on the 1-D
    FSDP mesh is gathered from each rank's local shard as a detached host
    copy (``all_gather_object`` over the group of ``mesh_or_group``, by
    default the tensor's own mesh), concatenated, trimmed to ``t.shape`` and
    put on ``t``'s device; a plain tensor passes through unchanged.  Every
    rank calls it together.  It uses neither DTensor's redistribution nor
    functional collectives: on gloo their ``wait_tensor`` crashed a rank.
    Any other placement raises."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    if tuple(t.placements) != (Shard(0),):
        raise ValueError(f"gather_full: {name} is placed as {tuple(t.placements)}, "
                         "not (Shard(0),) on a 1-D mesh")
    group = _group_of(t.device_mesh if mesh_or_group is None else mesh_or_group)
    local = t.to_local().detach()
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, local.cpu(), group=group)
    full = torch.cat(parts)[:t.shape[0]].reshape(t.shape)
    return full.to(local.device)


def _like(full: torch.Tensor, ref):
    """``full`` placed as ``ref`` is: this rank's shard of it when ``ref`` is
    a DTensor (every rank holds the same ``full``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(ref, DTensor):
        return full
    return distribute_tensor(full.to(ref.device), ref.device_mesh, ref.placements,
                             src_data_rank=None)


def full_model_state(state) -> Dict:
    """The bare model's state dict, whole, on every rank (FSDP gathers its
    shards: every rank calls it)."""
    if state.zero == "fsdp":
        return {k: gather_full(v, name=k) for k, v in state.model.state_dict().items()}
    return state.module.state_dict()


def full_state_dicts(state) -> Tuple[Optional[Dict], Optional[Dict]]:
    """The model's and the optimizer's state dicts, whole and in the
    one-process layout (the bare model's keys; the optimizer's state by
    parameter index).  Under a group every rank calls it (FSDP gathers its
    shards, ZeRO-1 consolidates the moments onto rank 0); ranks other than
    0 get ``(None, None)``."""
    rank0 = state.mesh is None or state.mesh.rank == 0
    network = full_model_state(state)
    if state.zero == "fsdp":
        opt = state.optimizer.state_dict()
        opt["state"] = {i: {k: gather_full(v, name=f"moment {i} {k}")
                            for k, v in s.items()}
                        for i, s in opt["state"].items()}
    elif state.zero == "zero1":
        state.optimizer.consolidate_state_dict(to=0)
        opt = state.optimizer.state_dict() if rank0 else None
    else:
        opt = state.optimizer.state_dict()
    return (network, opt) if rank0 else (None, None)


def load_full_state(state, network: Dict, optimizer: Dict) -> None:
    """Load a whole model and optimizer state dict (the one-process layout,
    from any mode and world size) into ``state``, in place; under a group
    every rank calls it with the same dicts."""
    if state.zero == "fsdp":
        current = state.model.state_dict()
        state.model.load_state_dict({k: _like(v, current[k]) for k, v in network.items()},
                                    strict=True)
        params = state.optimizer.param_groups[0]["params"]
        optimizer = dict(optimizer, state={
            i: {k: _like(v, params[i]) if k != "step" else v for k, v in s.items()}
            for i, s in optimizer["state"].items()})
    else:
        state.module.load_state_dict(network, strict=True)
    state.optimizer.load_state_dict(optimizer)
    if state.zero == "zero1":
        # ZeroRedundancyOptimizer.load_state_dict also copies the rank's entries
        # into the wrapper's own ``state`` (Optimizer.load_state_dict), which
        # nothing reads: a second device copy of the rank's moments
        state.optimizer.state.clear()
