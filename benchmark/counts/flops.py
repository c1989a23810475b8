"""FLOPs of a step, counted by ``FlopCounterMode`` over the benchmark's plain
reference on the ``meta`` device (shapes only, no data, no card): matrix
products, convolutions and attention, as the counter counts them.  The
sampler's MLP is counted through the reference's plain layers, the same
products the port's kernel computes."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.mano_layer import ManoBuffers
from benchmark.reference.mano_model import make_synthetic_mano
from benchmark.reference.model import HOISDF
from benchmark.reference.steps import compute_losses, eval_outputs, weighted_total


def _meta_batch(cfg, b: int, train: bool):
    h, w = cfg.input_img_shape
    hm = cfg.output_hm_shape[1]
    m = dict(device="meta")
    batch = {"img": torch.empty(b, h, w, 3, **m), "cam_intr": torch.empty(b, 3, 3, **m),
             "mano_root": torch.empty(b, 3, **m), "obj_center_cam": torch.empty(b, 3, **m),
             "bbox_hand": torch.empty(b, 4, **m), "bbox_obj": torch.empty(b, 4, **m),
             "hand_sdf_points": torch.empty(b, cfg.num_samp_hand, 3, **m),
             "obj_sdf_points": torch.empty(b, cfg.num_samp_obj, 3, **m),
             "hand_pre_points": torch.empty(b, cfg.num_samp_hand, 3, **m),
             "obj_pre_points": torch.empty(b, cfg.num_samp_obj, 3, **m)}
    forced = {"hand": torch.empty(b, cfg.num_samp_hand, 3, **m),
              "obj": torch.empty(b, cfg.num_samp_obj, 3, **m)}
    targets = {"hand_sdf": torch.empty(b, cfg.num_samp_hand, **m),
               "obj_sdf": torch.empty(b, cfg.num_samp_obj, **m),
               "joint_coord": torch.empty(b, 21, 2, **m),
               "joint_cam_no_trans": torch.empty(b, 21, 3, **m),
               "hand_seg": torch.empty(b, hm, hm, **m), "obj_seg": torch.empty(b, hm, hm, **m),
               "mano_param": torch.empty(b, 58, **m), "obj_rot": torch.empty(b, 3, **m),
               "rel_obj_trans": torch.empty(b, 3, **m)}
    return batch, forced, targets


def _model(cfg):
    with torch.device("meta"):
        return HOISDF(cfg).to("meta")  # the masks are made from numpy


def _mano():
    return ManoBuffers.from_model(make_synthetic_mano(0), "meta")


def _sampler_flops(cfg, b: int) -> int:
    """The sampler's probes (linear_sdfin and the decoder MLP on every row),
    less the reference's query of the given points, which the sampler takes
    from its last stage."""
    from benchmark import counts

    rows = b * (sum(counts.sampler_rows(cfg)) - cfg.num_samp_hand - cfg.num_samp_obj)
    ms = sum(ch for _, _, ch in counts.pyramid_shapes(cfg))
    sdfin = ms * 512 + 512 * cfg.hidden_dim
    return 2 * rows * (sdfin + sum(a * c for a, c in counts.mlp_layers(cfg)))


def eval_step_flops(cfg, b: int, supervise: bool) -> int:
    """FLOPs of one eval step at batch ``b``."""
    model = _model(cfg).eval().requires_grad_(False)  # the module tracker needs it
    batch, forced, _ = _meta_batch(cfg, b, False)
    with FlopCounterMode(display=False) as counter:
        eval_outputs(model, _mano(), batch, supervise_sdf=supervise, forced=forced)
    # the forward with the selection given counts no probe: add the sampler's
    return int(counter.get_total_flops()) + _sampler_flops(cfg, b)


def train_step_flops(cfg, b: int, field_guided: bool) -> int:
    """FLOPs of one train step (forward, losses and backward; the field-
    guided step's sampler forward only)."""
    model = _model(cfg).train()
    batch, forced, targets = _meta_batch(cfg, b, True)
    with FlopCounterMode(display=False) as counter:
        out = model(batch, use_presampled=not field_guided, dist_range=0.03,
                    forced=forced if field_guided else None)
        weighted_total(cfg, compute_losses(cfg, out, targets, _mano())).backward()
    return int(counter.get_total_flops()) + (_sampler_flops(cfg, b) if field_guided else 0)
