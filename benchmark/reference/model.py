"""HOISDF in plain PyTorch: the benchmark's reference model.

A frozen copy of the port's ``models/hoisdf.py`` (the "hier", "coarse2fine"
and "full" samplers, merged field queries) with its two kernels written as
plain ``torch`` operations: the pyramid gather is a per-level bilinear
gather and concatenation (:func:`gather`), differentiated by autograd, and
the sampler's SDF decode runs the decoder's layers without dropout
(``SDFDecoder.field``).  Module and parameter names are the port's, so one
state dict loads into both.

Two additions serve the comparison that judges the program:

- ``forward(..., forced=...)`` takes the token points of each field from the
  caller instead of selecting them (the program's own selection, read from
  its run, as a served model's tokens are read), and queries the field at
  them as the sampler would have.  The selection is judged on its own
  (:meth:`HOISDF.select`).
- :func:`layers.set_operand_rounding` rounds the operands of every product,
  which makes the lower-precision controls.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from benchmark.reference.decoder import Decoder, DecoderBig
from benchmark.reference.layers import Linear
from benchmark.reference.nerf import nerf_positional_encoding
from benchmark.reference.resnet import ResNetBackbone
from benchmark.reference.sampler import (
    scaled_to_cam,
    sdf_guided_sample,
    sdf_guided_sample_coarse2fine,
    sdf_guided_sample_hierarchical,
)
from benchmark.reference.sdf_decoder import SDFDecoder
from benchmark.reference.transformer import (
    Transformer,
    VoteTransformer,
    get_mano_memory_mask,
    get_mano_tgt_mask,
)


def _corners(grid: torch.Tensor, h: int, w: int):
    x = torch.clamp((grid[..., 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    y = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    return x0.long(), x1.long(), y0.long(), y1.long(), x - x0, y - y0


def bilinear(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NHWC ``feat`` at ``grid`` [B,P,2] in [-1, 1] (align_corners,
    border clamp) -> [B,P,C] in f32."""
    b, h, w, c = feat.shape
    x0, x1, y0, y1, wx, wy = _corners(grid, h, w)
    wx, wy = wx[..., None], wy[..., None]
    flat = feat.reshape(b, h * w, c)

    def corner(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1, c)).float()

    top = corner(y0, x0) * (1 - wx) + corner(y0, x1) * wx
    bot = corner(y1, x0) * (1 - wx) + corner(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def gather(pyramid: Mapping[str, torch.Tensor], grid: torch.Tensor,
           names: Sequence[str]) -> torch.Tensor:
    """Every named level at ``grid``, channel-concatenated -> [B, P, sum C]."""
    grid = grid.detach()
    return torch.cat([bilinear(pyramid[n], grid) for n in names], dim=-1)


def project_points(points_cam: torch.Tensor, cam_intr: torch.Tensor) -> torch.Tensor:
    p2d = torch.einsum("bpc,bkc->bpk", points_cam, cam_intr)
    return p2d[..., :2] / p2d[..., 2:3]


def pixels_to_grid(pix: torch.Tensor, img_shape) -> torch.Tensor:
    h, w = img_shape
    norm = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=pix.dtype, device=pix.device)
    return (pix - norm) / norm


class MLP(nn.Module):
    def __init__(self, in_dim: int, features: Sequence[int], relu_last: bool = False):
        super().__init__()
        dims = [in_dim, *features]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.relu_last = relu_last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.relu_last:
                x = torch.relu(x)
        return x


def sdf_attention_weight(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    b = torch.clamp(beta, min=2e-3)
    return torch.sigmoid(sdf / b) / b


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class HOISDF(nn.Module):
    """The port's module tree, in f32 (``cfg`` is any object with the port
    config's fields; ``compute_dtype`` is ignored: the reference computes in
    f32)."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.cfg = cfg
        backbone = ResNetBackbone(c.resnet_type)
        self.backbone_net = nn.ModuleDict({"resnet": backbone})
        decoder = (DecoderBig if c.use_big_decoder else Decoder)(backbone.skip_channels)
        self.decoder_net = nn.ModuleDict({"resnet_decoder": decoder})
        self.hand_sdf_decoder = SDFDecoder(c.hidden_dim, c.point_feat_size)
        self.obj_sdf_decoder = SDFDecoder(c.hidden_dim, c.point_feat_size)
        self.hand_transformer = Transformer(c.hidden_dim, c.nheads, c.enc_layers,
                                           c.dec_layers, c.dim_feedforward, c.dropout)
        self.obj_transformer = VoteTransformer(c.hidden_dim, c.nheads, c.enc_layers // 2,
                                               c.dim_feedforward, c.dropout)
        ms = sum(decoder.out_channels[name] for name in c.multiscale_layers)
        hd = c.hidden_dim
        self.linear_transformerin = MLP(ms, (1024, 512, 256, hd - c.point_feat_size),
                                        relu_last=True)
        self.linear_sdfin = MLP(ms, (512, hd), relu_last=True)
        self.hand_sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.obj_sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.mano_query_embed = nn.Embedding(c.mano_num_queries, hd)
        self.linear_pose = MLP(hd, (hd, hd, 6))
        self.linear_shape = MLP(hd, (hd, hd, 10))
        self.linear_handvote = MLP(hd, (hd, hd, hd, 20 * 3))
        self.linear_handcls = MLP(hd, (hd, hd, 20))
        self.linear_obj_rel_trans = MLP(hd, (hd, hd, 3))
        self.linear_obj_rot = MLP(hd, (hd, hd, 3))
        self.register_buffer("tgt_mask", get_mano_tgt_mask(c.mano_num_queries,
                                                           c.mano_shape_indx),
                             persistent=False)
        self.register_buffer("memory_mask", get_mano_memory_mask(
            c.mano_num_queries, c.num_samp_hand, c.num_samp_obj), persistent=False)

    # ---- field queries ------------------------------------------------------

    def _decoder_rows(self, pyramid, points_scaled, center, cam_intr, sdf_scale):
        c = self.cfg
        cam = scaled_to_cam(points_scaled, center, sdf_scale)
        grid = pixels_to_grid(project_points(cam, cam_intr), c.input_img_shape)
        fea = self.linear_sdfin(gather(pyramid, grid, c.multiscale_layers))
        posenc = nerf_positional_encoding(points_scaled, c.nerf_num_freqs)
        rows = torch.cat([fea, posenc, points_scaled], dim=-1)
        return rows.reshape(-1, rows.shape[-1])

    def _decoder(self, which: str) -> SDFDecoder:
        return self.hand_sdf_decoder if which == "hand" else self.obj_sdf_decoder

    def sdf_forward(self, pyramid, points_scaled, center, cam_intr, sdf_scale, which,
                    generator=None):
        """Clamped SDF at scaled-frame points, through the decoder's forward
        (dropout in train mode) -> [B, P, 1]."""
        rows = self._decoder_rows(pyramid, points_scaled, center, cam_intr, sdf_scale)
        sdf, _ = self._decoder(which)(rows, generator)
        c = self.cfg.clamping_distance
        return torch.clamp(sdf.reshape(*points_scaled.shape[:2], 1), -c, c)

    @torch.no_grad()
    def field(self, pyramid, points_scaled, center, cam_intr, sdf_scale, which):
        """The sampler's unclamped SDF at scaled-frame points -> [B, P]."""
        rows = self._decoder_rows(pyramid, points_scaled, center, cam_intr, sdf_scale)
        return self._decoder(which).field(rows).reshape(points_scaled.shape[:2])

    def _field_args(self, batch, which):
        c = self.cfg
        if which == "hand":
            return batch["mano_root"], batch["bbox_hand"], c.hand_sdf_scale, c.num_samp_hand
        return batch["obj_center_cam"], batch["bbox_obj"], c.obj_sdf_scale, c.num_samp_obj

    @torch.no_grad()
    def select(self, pyramid, batch, which):
        """The reference's own field-guided selection -> (points [B,K,3]
        scaled, sdf [B,K,1] clamped)."""
        c = self.cfg
        center, bbox, scale, k = self._field_args(batch, which)
        cam_intr = batch["cam_intr"]

        def sdf_fn(pts):
            return self.field(pyramid, pts, center, cam_intr, scale, which)

        common = dict(sdf_scale=scale, num_points=k, bins_n=c.bins_n,
                      clamp=c.clamping_distance)
        if c.sdf_infer_mode == "coarse2fine":
            return sdf_guided_sample_coarse2fine(
                sdf_fn, center, cam_intr, bbox, coarse_factor=c.bins_n // c.coarse_bins,
                keep_cells=c.coarse_keep_cells, **common)
        if c.sdf_infer_mode == "hier":
            levels = c.hier_levels
            if which == "obj" and c.hier_levels_obj is not None:
                levels = c.hier_levels_obj
            return sdf_guided_sample_hierarchical(sdf_fn, center, cam_intr, bbox,
                                                  levels=levels, **common)
        return sdf_guided_sample(sdf_fn, center, cam_intr, bbox, chunk=c.sdf_infer_chunk,
                                 **common)

    # ---- the forward ----------------------------------------------------------

    def backbone(self, batch):
        """-> (decoder heads [B,H,W,3], the NHWC pyramid)."""
        img = batch["img"].float().permute(0, 3, 1, 2)
        img_feat, skips = self.backbone_net["resnet"](img)
        pyr, heads = self.decoder_net["resnet_decoder"](img_feat, skips)
        return heads.permute(0, 2, 3, 1), {k: _nhwc(v) for k, v in pyr.items()}

    def forward(self, batch: Dict[str, torch.Tensor], *, supervise_sdf: bool = True,
                use_presampled: bool = False, dist_range: float = 0.0,
                generator: Optional[torch.Generator] = None,
                forced: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
        """The port's forward in the module's mode.  ``forced`` maps "hand"
        and "obj" to scaled-frame token points [B,K,3] that replace the
        field-guided selection."""
        c = self.cfg
        out: Dict[str, Any] = {}
        mano_root, obj_center = batch["mano_root"], batch["obj_center_cam"]
        cam_intr = batch["cam_intr"]
        out["decoder_heads"], pyramid = self.backbone(batch)

        if supervise_sdf:
            out["hand_sdf_pred"] = self.sdf_forward(
                pyramid, batch["hand_sdf_points"], mano_root, cam_intr, c.hand_sdf_scale,
                "hand", generator)
            out["obj_sdf_pred"] = self.sdf_forward(
                pyramid, batch["obj_sdf_points"], obj_center, cam_intr, c.obj_sdf_scale,
                "obj", generator)

        if use_presampled:
            def jitter(pts):
                u = torch.rand(pts.shape, generator=generator, device=pts.device)
                return pts + (u * 2.0 - 1.0) * dist_range

            hand_points = jitter(batch["hand_pre_points"])
            obj_points = jitter(batch["obj_pre_points"])
            hand_sdf = self.sdf_forward(pyramid, hand_points, mano_root, cam_intr,
                                        c.hand_sdf_scale, "hand", generator)
            obj_sdf = self.sdf_forward(pyramid, obj_points, obj_center, cam_intr,
                                       c.obj_sdf_scale, "obj", generator)
        else:
            picked = {}
            for which in ("hand", "obj"):
                if forced is not None:
                    pts = forced[which].float()
                    center, _, scale, _ = self._field_args(batch, which)
                    sdf = self.field(pyramid, pts, center, cam_intr, scale, which)
                    sdf = torch.clamp(sdf, -c.clamping_distance, c.clamping_distance)[..., None]
                    picked[which] = (pts, sdf)
                else:
                    picked[which] = self.select(pyramid, batch, which)
            (hand_points, hand_sdf), (obj_points, obj_sdf) = picked["hand"], picked["obj"]
        hand_posenc = nerf_positional_encoding(hand_points, c.nerf_num_freqs)
        obj_posenc = nerf_positional_encoding(obj_points, c.nerf_num_freqs)
        sigma_hand = sdf_attention_weight(hand_sdf.detach(), self.hand_sigmoid_beta)
        sigma_obj = sdf_attention_weight(obj_sdf.detach(), self.obj_sigmoid_beta)

        # token features and the cross-field queries off one merged gather
        ph = hand_points.shape[1]
        hand_cam = scaled_to_cam(hand_points, mano_root, c.hand_sdf_scale)
        obj_cam = scaled_to_cam(obj_points, obj_center, c.obj_sdf_scale)
        grid = pixels_to_grid(project_points(torch.cat([hand_cam, obj_cam], dim=1), cam_intr),
                              c.input_img_shape)
        feats = gather(pyramid, grid, c.multiscale_layers)
        tok = self.linear_transformerin(feats)
        hand_fea, obj_fea = tok[:, :ph], tok[:, ph:]
        # the original's unscaled cross frames ("# bug"), as the port keeps them
        hand_o_points = (hand_cam - obj_center[:, None, :]) * c.obj_sdf_scale
        obj_h_points = (obj_cam - mano_root[:, None, :]) * c.hand_sdf_scale
        cross_fea = self.linear_sdfin(feats)
        hand_o_posenc = nerf_positional_encoding(hand_o_points, c.nerf_num_freqs)
        obj_h_posenc = nerf_positional_encoding(obj_h_points, c.nerf_num_freqs)

        def cross_sdf(fea, posenc, pts, decoder):
            rows = torch.cat([fea, posenc, pts], dim=-1)
            sdf, _ = decoder(rows.reshape(-1, rows.shape[-1]), generator)
            sdf = sdf.reshape(*pts.shape[:2], 1)
            return torch.clamp(sdf, -c.clamping_distance, c.clamping_distance)

        hand_o_sdf = cross_sdf(cross_fea[:, :ph], hand_o_posenc, hand_o_points,
                               self.obj_sdf_decoder)
        obj_h_sdf = cross_sdf(cross_fea[:, ph:], obj_h_posenc, obj_h_points,
                              self.hand_sdf_decoder)

        hand_points_notrans = hand_cam - mano_root[:, None, :]
        obj_points_notrans = obj_cam - obj_center[:, None, :]
        hand_o_points_notrans = hand_cam - obj_center[:, None, :]
        obj_h_points_notrans = obj_cam - mano_root[:, None, :]
        sigma_hand_o = sdf_attention_weight(hand_o_sdf.detach(), self.obj_sigmoid_beta)
        sigma_obj_h = sdf_attention_weight(obj_h_sdf.detach(), self.hand_sigmoid_beta)

        hand_src = torch.cat([
            torch.cat([hand_points_notrans, hand_posenc, hand_fea * sigma_hand], -1),
            torch.cat([obj_h_points_notrans, obj_h_posenc, obj_fea * sigma_obj_h],
                      -1).detach(),
        ], dim=1)
        obj_src = torch.cat([
            torch.cat([obj_points_notrans, obj_posenc, obj_fea * sigma_obj], -1),
            torch.cat([hand_o_points_notrans, hand_o_posenc, hand_fea * sigma_hand_o],
                      -1).detach(),
        ], dim=1)

        hs, _memory, hand_enc_out, _ = self.hand_transformer(
            hand_src, torch.zeros_like(hand_src), self.mano_query_embed.weight,
            self.tgt_mask, self.memory_mask, generator=generator)
        _obj_memory, obj_enc_out = self.obj_transformer(
            obj_src, torch.zeros_like(obj_src), generator=generator)

        hand_enc_hand = hand_enc_out[:, :, : c.num_samp_hand]
        out["hand_off"] = self.linear_handvote(hand_enc_hand)
        out["hand_cls"] = self.linear_handcls(hand_enc_hand)
        obj_enc_obj = obj_enc_out[:, :, : c.num_samp_obj]
        out["obj_rot"] = self.linear_obj_rot(obj_enc_obj)
        out["obj_trans"] = self.linear_obj_rel_trans(obj_enc_obj)
        out["mano_pose6d"] = self.linear_pose(hs[:, :, : c.mano_shape_indx])
        out["mano_shape"] = self.linear_shape(hs[:, :, c.mano_shape_indx])
        out["hand_points_notrans"] = hand_points_notrans
        out["hand_points"] = hand_points
        out["obj_points"] = obj_points
        out["hand_sdf"] = hand_sdf
        out["obj_sdf"] = obj_sdf
        return out
