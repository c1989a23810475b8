"""Train and eval steps of the port (``hoisdf_tpu/train.py``).

AdamW with the stepped learning rate and its floor, the backbone-BN freeze,
the losses with the train loop's weighting, the train step of both branches
(jittered ground-truth-near points, or the field-guided sampler), the
host-side branch gate, and the eval forward with joint voting and the
final-layer MANO head.  While a ``torch.profiler`` runs, the steps record
their stages as spans (``utils/profiling.py``): ``train.step`` with
``train.forward``, ``train.losses``, ``train.backward`` and
``train.optimizer``; ``eval.step`` with ``eval.decode`` and ``eval.mano``, or
under the IK head ``eval.ik`` (with ``ik.template``, ``ik.solve`` and
``ik.mano``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hoisdf_torch.config import Config
from hoisdf_torch.losses import (
    bce,
    joint_heatmap_loss,
    joint_vote_loss,
    mano_loss,
    mano_shape_loss,
    sdf_part_classifier_loss,
    sep_sdf_loss,
    smooth_l1,
    weighted_total,
)
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.models.hoisdf import HOISDF
from hoisdf_torch.models.initializers import apply_reference_init
from hoisdf_torch.models.mano_head import mano_head_gt, mano_head_pred
from hoisdf_torch.ops import wire
from hoisdf_torch.ops.heatmap import render_gaussian_heatmap
from hoisdf_torch.ops.ik import ik_solver_mano
from hoisdf_torch.parallel.mesh import Mesh, mean_over_ranks, world_size
from hoisdf_torch.parallel.zero import replicate, shard_state
from hoisdf_torch.utils.profiling import span


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked for
    (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def disable_tf32() -> None:
    """The port's precision: ``Config.compute_dtype`` names the one reduced
    precision the model takes (bf16 in the backbone, pyramid, heads and SDF
    MLP, for serving); every other op, and every op at "float32" (the
    preset's, and training's), runs in full f32.  So TF32 is off for cuBLAS
    and for cuDNN, whose default would run f32 convolutions in TF32.  The
    flags are process-wide; every entry point (train state, train step, eval
    step) sets them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _to_device(arrays: Mapping, dev: torch.device, pin: bool = False
               ) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``dev``, copied with
    ``non_blocking``.  A tensor already on ``dev`` passes as it is; a pinned
    host tensor is copied without holding the host.  A numpy array lies in
    pageable memory, whose copy may hold the host until the card reaches it;
    with ``pin`` (on the card) it is first copied into pinned memory from
    torch's caching host allocator, which keeps the block until its copy
    has run."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
            if pin and dev.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(dev, non_blocking=True)
    return out


# ---- optimizer and schedule --------------------------------------------------

def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """StepLR gamma^(epoch // lr_drop) with the original's 1e-5 floor."""
    return max(cfg.lr * cfg.lr_decay_gamma ** (epoch // cfg.lr_drop), cfg.lr_floor)


def lr_for_step(cfg: Config, step: int, steps_per_epoch: int) -> float:
    """The learning rate of optimizer step ``step`` (0-based)."""
    return lr_for_epoch(cfg, step // steps_per_epoch)


def is_frozen(name: str) -> bool:
    """The original's BN freeze (main/model.py:118-121): backbone parameters
    of the stem and block BNs ``bn1`` / ``bn2`` / ``bn3`` take no update and
    no weight decay.  Its name filter misses the ``downsample.1`` BNs, which
    train; the running statistics of every BN still update."""
    parts = name.split(".")
    return parts[0] == "backbone_net" and any(p in ("bn1", "bn2", "bn3") for p in parts)


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-2) over every
    parameter but the frozen BNs.  torch's AdamW steps
    p <- p * (1 - lr * wd) - lr * m_hat / (sqrt(v_hat) + eps), which is
    optax's ``adamw`` (the JAX package's optimizer) with the decay scaled by
    the learning rate: the same update."""
    params = [p for n, p in model.named_parameters() if not is_frozen(n)]
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-2)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps taken.
    Under a process group ``model`` is the data-parallel model (DDP, or the
    model itself sharded by FSDP) and ``optimizer`` may be ZeRO-1's;
    :attr:`module` is the bare model."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    steps_per_epoch: int
    step: int = 0
    mesh: Optional[Mesh] = None
    zero: str = "off"

    @property
    def module(self) -> HOISDF:
        """The bare model, for the eval step and the snapshots."""
        if isinstance(self.model, torch.nn.parallel.DistributedDataParallel):
            return self.model.module
        return self.model


ZERO_MODES = ("off", "zero1", "fsdp")


def create_train_state(cfg: Config, model: HOISDF, steps_per_epoch: int = 1000, *,
                       device="cuda", mesh: Optional[Mesh] = None,
                       zero: str = "off") -> TrainState:
    """Move ``model`` to ``device`` and give it its optimizer.  With
    ``cfg.reference_init`` the decoder, SDF decoders and transformers are
    first re-drawn by the original's train-mode init, from ``cfg.seed``.

    With a ``mesh`` that holds a process group the state is data parallel
    (:func:`make_data_parallel`).  Every rank must start from the same
    weights."""
    dev = resolve_device(device)
    disable_tf32()
    if cfg.reference_init:
        apply_reference_init(model, torch.Generator().manual_seed(cfg.seed + 3))
    model.to(dev)
    return make_data_parallel(TrainState(model, make_optimizer(cfg, model), steps_per_epoch),
                              mesh, zero)


def make_data_parallel(state: TrainState, mesh: Optional[Mesh], zero: str = "off"
                       ) -> TrainState:
    """A one-process state whose optimizer has not stepped, on ``mesh``:
    without a process group as it is; with one the model in DDP
    (``zero="off"``), in DDP with ZeRO-1's optimizer (``"zero1"``) or
    sharded by FSDP (``"fsdp"``), as ``parallel/zero.py`` says."""
    if zero not in ZERO_MODES:
        raise ValueError(f"zero={zero!r}; one of {ZERO_MODES}")
    state.mesh = mesh
    if mesh is None or not mesh.distributed:
        if zero != "off":
            raise ValueError(f"zero={zero!r} needs a process group")
        return state
    if zero == "off":
        state.model = replicate(state.model, mesh)
        return state
    return shard_state(state, mesh, shard_params=zero == "fsdp")


# ---- losses ----------------------------------------------------------------

def compute_losses(cfg: Config, out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                   mano_buffers: ManoBuffers, *, with_sdf: bool = True
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Every training loss as a scalar, and the aggregated hand joints and
    MANO meshes (``hoisdf_tpu/train.py::compute_losses``)."""
    losses: Dict[str, torch.Tensor] = {}
    aux: Dict[str, torch.Tensor] = {}
    clamp = cfg.clamping_distance
    if with_sdf:
        losses["sdfhand_loss"], losses["sdfobj_loss"] = sep_sdf_loss(
            out["hand_sdf_pred"], out["obj_sdf_pred"],
            torch.clamp(targets["hand_sdf"], -clamp, clamp),
            torch.clamp(targets["obj_sdf"], -clamp, clamp))
        gt_hm = render_gaussian_heatmap(
            targets["joint_coord"], (cfg.output_hm_shape[1], cfg.output_hm_shape[2]), cfg.sigma)
        heads = out["decoder_heads"]
        losses["joint_heatmap"] = joint_heatmap_loss(heads[..., 0], gt_hm)
        losses["hand_seg"] = torch.mean(bce(heads[..., 1], targets["hand_seg"]))
        losses["obj_seg"] = torch.mean(bce(heads[..., 2], targets["obj_seg"]))
        if cfg.classifier_branch and "hand_cls_logits" in out and "hand_part_labels" in targets:
            losses["sdf_cls_loss"] = sdf_part_classifier_loss(
                out["hand_cls_logits"], targets["hand_part_labels"])

    joints_gt = targets["joint_cam_no_trans"][:, 1:]  # mm, root excluded
    (losses["loss_joint_3d"], losses["loss_joint_cls"], losses["loss_all_joint_3d"],
     hand_joints) = joint_vote_loss(cfg, out["hand_points_notrans"], out["hand_off"],
                                    out["hand_cls"], joints_gt)
    aux["hand_joints"] = hand_joints[-1]

    if cfg.use_inverse_kinematics:  # one shape query; the pose comes from IK at eval
        losses.update(mano_shape_loss(cfg, out["mano_shape"], targets["mano_param"][:, -10:]))
        aux["mano_shape"] = out["mano_shape"][-1]
    else:
        pred_mano = mano_head_pred(mano_buffers, out["mano_pose6d"], out["mano_shape"])
        gt_mano = mano_head_gt(mano_buffers, targets["mano_param"])
        losses.update(mano_loss(cfg, pred_mano, gt_mano))
        aux["mano_verts"] = pred_mano["verts3d"][-1]
        aux["mano_joints"] = pred_mano["joints3d"][-1]
        aux["mano_joints_gt"] = gt_mano["joints3d"]
        aux["mano_verts_gt"] = gt_mano["verts3d"]

    losses["obj_rot"] = torch.mean(smooth_l1(
        out["obj_rot"], targets["obj_rot"][None, :, None].expand(out["obj_rot"].shape)))
    losses["obj_trans"] = torch.mean(smooth_l1(
        out["obj_trans"],
        targets["rel_obj_trans"][None, :, None].expand(out["obj_trans"].shape)))
    return losses, aux


# ---- train step ------------------------------------------------------------

def make_train_step(cfg: Config, mano_buffers: ManoBuffers, *, device="cuda"
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step on ``device``: ``step(state, inputs, targets, generator,
    dist_range, *, use_presampled)`` decodes the wire, runs the forward in
    train mode (``generator``, on the device, draws the jitter and the
    dropout masks), back-propagates the weighted total, takes one AdamW step
    at the step's learning rate and returns ``(state, losses)``, the losses
    (with ``total``) as detached scalars on the device.  The state is updated
    in place.

    Data parallel (a state from ``create_train_state(..., mesh=...)``), each
    rank passes its rows of the global batch, on its own device, and a
    generator seeded for its rank (``parallel.mesh.rank_seed``); every rank
    must take the same branch.  The step then computes the JAX package's
    global-batch step: BN on the global statistics, the count-normalised
    losses over the global counts, the gradients averaged over the ranks,
    and it returns the global batch's losses on every rank."""
    dev = resolve_device(device)
    disable_tf32()
    mano = mano_buffers.to(dev)

    def train_step(state: TrainState, inputs: Mapping, targets: Mapping,
                   generator: Optional[torch.Generator], dist_range: float, *,
                   use_presampled: bool):
        with span("train.step"):
            model = state.model.train()
            batch = wire.decode_inputs(_to_device(inputs, dev))
            tg = wire.decode_targets(_to_device(targets, dev))
            lr = lr_for_step(cfg, state.step, state.steps_per_epoch)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            model.zero_grad(set_to_none=True)
            with span("train.forward"):
                out = model(batch, use_presampled=use_presampled,
                            dist_range=float(dist_range), generator=generator)
            with span("train.losses"):
                losses, _ = compute_losses(cfg, out, tg, mano)
                total = weighted_total(cfg, losses)
            with span("train.backward"):
                total.backward()
            with span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
            losses = {k: v.detach() for k, v in losses.items()}
            losses["total"] = total.detach()
            if world_size() > 1:  # the global batch's losses, on every rank
                losses = dict(zip(losses, mean_over_ranks(torch.stack(list(losses.values())))))
        return state, losses

    return train_step


def presample_gate(cfg: Config, epoch: int, batch_ratio: float, p: float
                   ) -> Tuple[bool, float]:
    """Host-side branch choice (main/model.py:426-432): the presampled branch
    when ``p`` < 0.4 or before ``point_sampling_epoch``; the jitter distance
    by the batch's progress through the epoch.  -> (use_presampled,
    dist_range)."""
    use_pre = p < 0.4 or epoch < cfg.point_sampling_epoch
    idx = sum(1 for r in cfg.random_ratio if batch_ratio > r)
    return use_pre, cfg.random_move_dist[idx]


# ---- eval step ---------------------------------------------------------------

def vote_hand_joints(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Softmax-weighted per-point joint votes of the final layer -> [B,20,3] m."""
    off = out["hand_off"]
    votes = out["hand_points_notrans"][None, :, :, None, :] + off.reshape(*off.shape[:3], 20, 3)
    weights = torch.softmax(out["hand_cls"], dim=2)[..., None]
    return torch.sum(votes * weights, dim=2)[-1]


def solve_hand_ik(mano: ManoBuffers, hand_joints: torch.Tensor, mano_shape: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The IK head's hand: the voted joints [B, 20, 3] with the root (0)
    prepended and the predicted shape [B, 10] through ``ops/ik.py``'s
    solver, in f32 -> ``mano_joints`` [B, 21, 3] and ``mano_verts``
    [B, 778, 3] (root-relative metres), ``mano_pose`` [B, 48] and
    ``ik_valid`` [B] (0 where Kabsch gave a reflection)."""
    joints = hand_joints.float()
    joints = torch.cat([torch.zeros_like(joints[:, :1]), joints], dim=1)
    ik = ik_solver_mano(mano, joints, mano_shape.float())
    return {"mano_joints": ik["joints"], "mano_verts": ik["verts"], "mano_pose": ik["pose"],
            "ik_valid": ik["vis"][:, 0]}


def make_eval_step(cfg: Config, model: HOISDF, mano_buffers: ManoBuffers,
                   supervise_sdf: Optional[bool] = None, *, device="cuda"
                   ) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """Eval forward on ``device``: field-guided sampling, running BN, MANO on
    the final decoder layer.  Moves ``model`` to the device and puts it in
    eval mode.  The returned step takes numpy arrays or tensors (u8 or f32
    image wire) and returns tensors on the device.  It makes no call that
    waits for the card: tensors already on the device pass as they are,
    pinned host tensors and numpy arrays (through pinned memory) are copied
    without holding the host, so a caller can enqueue the next step while
    this one runs.

    ``supervise_sdf`` defaults to the DexYCB behaviour (also query the SDF at
    the ground-truth sample points); pass False for serving.  Under
    ``use_inverse_kinematics`` the step solves the hand on the device from
    the voted joints and the shape query's ``mano_shape`` [B, 10]
    (:func:`solve_hand_ik`, in f32) and returns the meshes as the other
    presets do, with the solved axis-angle ``mano_pose`` [B, 48] and the
    Kabsch flag ``ik_valid`` [B] (int32)."""
    dev = resolve_device(device)
    disable_tf32()
    supervise = cfg.dataset == "dexycb" if supervise_sdf is None else supervise_sdf
    model.to(dev).eval()
    mano = mano_buffers.to(dev)

    def eval_step(inputs: Mapping) -> Dict[str, torch.Tensor]:
        with span("eval.step"), torch.inference_mode():
            with span("eval.decode"):
                batch = wire.decode_inputs(_to_device(inputs, dev, pin=True))
            out = model(batch, supervise_sdf=supervise)
            preds = {
                "obj_rot": out["obj_rot"][-1],
                "obj_trans": out["obj_trans"][-1],
                "hand_points_notrans": out["hand_points_notrans"],
                "hand_off": out["hand_off"],
                "hand_cls": out["hand_cls"],
                "decoder_heads": out["decoder_heads"],
                "hand_joints": vote_hand_joints(out),
            }
            if cfg.use_inverse_kinematics:
                preds["mano_shape"] = out["mano_shape"][-1]
                with span("eval.ik"):
                    preds.update(solve_hand_ik(mano, preds["hand_joints"], preds["mano_shape"]))
            else:  # MANO on the final decoder layer only, which eval reads
                with span("eval.mano"):
                    pred_mano = mano_head_pred(mano, out["mano_pose6d"][-1:],
                                               out["mano_shape"][-1:])
                preds["mano_verts"] = pred_mano["verts3d"][-1]
                preds["mano_joints"] = pred_mano["joints3d"][-1]
        return preds

    return eval_step
