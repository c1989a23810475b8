"""Snapshots of a training run (``hoisdf_tpu/utils/checkpoint.py``), in the
original repo's layout: ``model_dir/snapshot_{epoch}.pth.tar``, a
``torch.save`` of ``{"epoch", "network", "optimizer", "step"}`` whose
``network`` keys carry the ``module.`` prefix of the original's DataParallel
model (``common/base.py:113-118``), so
``hoisdf_tpu/tools/convert_torch_ckpt.py`` reads it.  Resume takes the latest
snapshot, as the original's ``--continue`` does; the learning rate follows
from the step count.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from hoisdf_torch.parallel.zero import full_state_dicts, load_full_state

_SNAP_RE = re.compile(r"snapshot_(\d+)\.pth\.tar$")
_PREFIX = "module."


def snapshot_path(model_dir: str, epoch: int) -> str:
    return os.path.join(model_dir, f"snapshot_{epoch}.pth.tar")


def save_snapshot(model_dir: str, epoch: int, state) -> str:
    """Write ``state``'s (a ``train.TrainState``) model, optimizer and step
    as snapshot ``epoch``; returns the path.  A data-parallel state is
    written in the one-process layout, whole (``parallel/zero.py``): every
    rank calls this, and rank 0 alone writes."""
    path = snapshot_path(model_dir, epoch)
    network, optimizer = full_state_dicts(state)
    if network is None:  # not rank 0
        return path
    os.makedirs(model_dir, exist_ok=True)
    network = {_PREFIX + k: v.detach().cpu() for k, v in network.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"epoch": epoch, "network": network, "optimizer": optimizer,
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(model_dir: str) -> Optional[int]:
    if not os.path.isdir(model_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_SNAP_RE.match, os.listdir(model_dir)) if m]
    return max(epochs) if epochs else None


def restore_snapshot(model_dir: str, state, epoch: Optional[int] = None) -> Optional[int]:
    """Load snapshot ``epoch`` (default: the latest) into ``state`` in place:
    model (strict), optimizer and step.  Returns the snapshot's epoch, or
    None when the directory holds none.  A snapshot of any mode and world
    size loads into any other; under a group every rank calls this."""
    if epoch is None:
        epoch = latest_epoch(model_dir)
        if epoch is None:
            return None
    snap = torch.load(snapshot_path(model_dir, epoch), map_location="cpu", weights_only=True)
    load_full_state(state, _strip_prefix(snap["network"]), snap["optimizer"])
    state.step = int(snap["step"])
    return int(snap["epoch"])


def _strip_prefix(network):
    return {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v for k, v in network.items()}


def load_network(model_dir: str, epoch: Optional[int] = None):
    """The model state dict of snapshot ``epoch`` (default: the latest), or
    None when the directory holds none."""
    if epoch is None:
        epoch = latest_epoch(model_dir)
        if epoch is None:
            return None
    snap = torch.load(snapshot_path(model_dir, epoch), map_location="cpu", weights_only=True)
    return _strip_prefix(snap["network"])


# Keys of an original snapshot that the port's model does not have: the
# unused model-level norm1, the dead heads linear_objvote / linear_objcls, and
# the MANO layer's buffers (hoisdf_tpu/tools/convert_torch_ckpt.py:33-39).
# BatchNorm counters are dropped too and taken from the model, so a state dict
# without them loads as well.
_ORIGINAL_SKIP = re.compile(
    r"^(norm1\.|linear_objvote\.|linear_objcls\.|mano_head\.mano_layer\.)|num_batches_tracked$")


def load_original_state(path: str, model: torch.nn.Module):
    """An original ``snapshot_*.pth.tar`` (its ``network`` entry, or a bare
    state dict) as a state dict for ``model.load_state_dict(...,
    strict=True)``."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    network = raw.get("network", raw)
    state = {k: v for k, v in _strip_prefix(network).items() if not _ORIGINAL_SKIP.search(k)}
    state.update({k: v for k, v in model.state_dict().items()
                  if k.endswith("num_batches_tracked")})
    return state
