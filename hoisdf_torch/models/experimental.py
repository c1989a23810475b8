"""Opt-in model variants kept out of the core forward
(``hoisdf_tpu/models/experimental.py``).
"""

from __future__ import annotations

import torch

from hoisdf_torch.ops.grid_sample import pixels_to_grid, project_points
from hoisdf_torch.ops.kernels.sdf_mlp import fold_weight_norm, prepare_weights, sdf_mlp
from hoisdf_torch.ops.nerf import nerf_positional_encoding
from hoisdf_torch.ops.point_sampling import scaled_to_cam, sdf_guided_sample_hierarchical
from hoisdf_torch.parallel.zero import unsharded


@torch.no_grad()
def paired_sdf_infer(model, pyramid, mano_root, obj_center, cam_intr, bbox_hand, bbox_obj):
    """Hand and object field-guided sampling as one grouped "hier" cascade
    (``cfg.paired_sdf_infer``).

    The batch axis carries both groups b-major ([b0 hand, b0 obj, b1 hand,
    ...]) for the selection (bbox tests, per-group top-K, subdivision), with
    a per-item scale; each probe's field query merges the groups along the
    point axis, so the pyramid gather, ``linear_sdfin`` and the posenc run
    once on [B, 2M] points, and only the SDF MLP runs per field (two
    launches, each decoder's weights).  Both groups run the shared
    ``hier_levels`` (one keep per stage), so a conflicting
    ``hier_levels_obj`` raises; the per-group probes, scores and top-K are
    then those of two ``sdf_infer`` calls, and the object's points are the
    first ``num_samp_obj`` of the shared K.  ``model`` is the HOISDF module.
    Returns ((points, sdf, posenc) of the hand, (...) of the object).
    """
    c = model.cfg
    if c.hier_levels_obj not in (None, c.hier_levels):
        raise ValueError(
            "paired_sdf_infer folds both fields into one cascade and cannot honor a "
            f"per-field hier_levels_obj={c.hier_levels_obj!r}; set hier_levels_obj=None "
            "(or equal to hier_levels) to use the paired sampler")
    b, dev = mano_root.shape[0], mano_root.device
    decoders = (model.hand_sdf_decoder, model.obj_sdf_decoder)
    centers = torch.stack([mano_root, obj_center], dim=1).reshape(2 * b, 3)
    bboxes = torch.stack([bbox_hand, bbox_obj], dim=1).reshape(2 * b, 4)
    scales = torch.stack([torch.full((b,), c.hand_sdf_scale, device=dev),
                          torch.full((b,), c.obj_sdf_scale, device=dev)], dim=1).reshape(-1)
    cam2 = torch.repeat_interleave(cam_intr, 2, dim=0)

    def sdf_fn(pts):  # [2B, M, 3] b-major -> [2B, M]
        m = pts.shape[1]
        merged_cam = scaled_to_cam(pts, centers, scales).reshape(b, 2 * m, 3)
        grid = pixels_to_grid(project_points(merged_cam, cam_intr), c.input_img_shape)
        rows = model._decoder_rows(pyramid, grid.contiguous(), pts.reshape(b, 2 * m, 3),
                                   nearest=c.infer_gather_nearest)
        halves = rows.reshape(b, 2, m, -1)
        return torch.stack([sdf_mlp(halves[:, g].reshape(b * m, -1).contiguous(),
                                    weights[g]).reshape(b, m) for g in range(2)],
                           dim=1).reshape(2 * b, m)

    k = max(c.num_samp_hand, c.num_samp_obj)
    with unsharded(*decoders):  # the kernel reads their weights (FSDP: gathered)
        weights = [prepare_weights(fold_weight_norm(dec), model.compute_dtype)
                   for dec in decoders]
        points, sdf = sdf_guided_sample_hierarchical(
            sdf_fn, centers, cam2, bboxes, sdf_scale=scales, num_points=k, bins_n=c.bins_n,
            levels=c.hier_levels, clamp=c.clamping_distance)
    points, sdf = points.reshape(b, 2, k, 3), sdf.reshape(b, 2, k, 1)
    out = []
    for g, n in enumerate((c.num_samp_hand, c.num_samp_obj)):
        pts = points[:, g, :n]
        out.append((pts, sdf[:, g, :n], nerf_positional_encoding(pts, c.nerf_num_freqs)))
    return tuple(out)
