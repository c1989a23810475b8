"""HOISDF: global-SDF-guided hand+object pose estimation, eval forward
(``hoisdf_tpu/models/hoisdf.py``).

The eval branch only: points come from the field-guided sampler
(``use_presampled=False``), token features and cross-field queries share one
merged pyramid gather (``merged_field_queries=True``), and the hand and object
cascades run separately.  Module and parameter names are the original PyTorch
HOISDF's; the dead heads ``linear_objvote`` / ``linear_objcls`` and the unused
``norm1`` are left out, as in the JAX package.

The two hot kernels run here: every cascade probe gathers its pyramid
features through ``gather_lerp`` and scores them through ``sdf_mlp``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
from torch import nn

from hoisdf_torch.config import Config
from hoisdf_torch.models.decoder import Decoder
from hoisdf_torch.models.layers import Linear
from hoisdf_torch.models.resnet import ResNetBackbone
from hoisdf_torch.models.sdf_decoder import SDFDecoder, WeightNormLinear
from hoisdf_torch.models.transformer import (
    MultiheadAttention,
    Transformer,
    VoteTransformer,
    get_mano_memory_mask,
    get_mano_tgt_mask,
)
from hoisdf_torch.ops.grid_sample import (
    multiscale_point_features,
    pixels_to_grid,
    project_points,
)
from hoisdf_torch.ops.kernels.sdf_mlp import fold_weight_norm, prepare_weights, sdf_mlp
from hoisdf_torch.ops.nerf import nerf_positional_encoding
from hoisdf_torch.ops.point_sampling import scaled_to_cam, sdf_guided_sample_hierarchical


class MLP(nn.Module):
    """Plain ReLU MLP; ``features`` lists every layer's output dim."""

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
    """sigma = sigmoid(s / beta) / beta with beta clamped to >= 2e-3 at use."""
    b = torch.clamp(beta, min=2e-3)
    return torch.sigmoid(sdf / b) / b


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC; a view when x is already channels_last."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


class HOISDF(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.compute_dtype = getattr(torch, c.compute_dtype)
        backbone = ResNetBackbone(c.resnet_type)
        self.backbone_net = nn.ModuleDict({"resnet": backbone})
        self.decoder_net = nn.ModuleDict({"resnet_decoder": Decoder(backbone.skip_channels)})
        self.hand_sdf_decoder = SDFDecoder(c.hidden_dim, c.point_feat_size)
        self.obj_sdf_decoder = SDFDecoder(c.hidden_dim, c.point_feat_size)
        self.hand_transformer = Transformer(c.hidden_dim, c.nheads, c.enc_layers,
                                           c.dec_layers, c.dim_feedforward)
        self.obj_transformer = VoteTransformer(c.hidden_dim, c.nheads, c.enc_layers // 2,
                                               c.dim_feedforward)
        ms, hd = c.multiscale_dim, c.hidden_dim
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

    # ---- field queries -----------------------------------------------------

    def _gather_grid(self, points_scaled, center, cam_intr, sdf_scale):
        cam_pts = points_scaled / sdf_scale + center[:, None, :]
        grid = pixels_to_grid(project_points(cam_pts, cam_intr), self.cfg.input_img_shape)
        return grid.contiguous(), cam_pts

    def _sdf_decoder_inputs(self, pyramid, points_scaled, center, cam_intr, sdf_scale):
        """Flat [B*P, in] decoder inputs (pixel feature ++ posenc ++ xyz)."""
        c = self.cfg
        grid, _ = self._gather_grid(points_scaled, center, cam_intr, sdf_scale)
        feats = multiscale_point_features(pyramid, grid, c.multiscale_layers)
        points_fea = self.linear_sdfin(feats.to(self.compute_dtype))
        posenc = nerf_positional_encoding(points_scaled, c.nerf_num_freqs)
        dec_in = torch.cat([points_fea.float(), posenc, points_scaled], dim=-1)
        return dec_in.to(self.compute_dtype).reshape(-1, dec_in.shape[-1])

    def sdf_forward(self, pyramid, points_scaled, center, cam_intr, sdf_scale, which):
        """Clamped SDF at arbitrary scaled-frame points -> [B, P, 1] f32."""
        flat = self._sdf_decoder_inputs(pyramid, points_scaled, center, cam_intr, sdf_scale)
        decoder = self.hand_sdf_decoder if which == "hand" else self.obj_sdf_decoder
        sdf = decoder(flat).reshape(*points_scaled.shape[:2], 1).float()
        c = self.cfg.clamping_distance
        return torch.clamp(sdf, -c, c)

    def sdf_infer(self, pyramid, center, cam_intr, bbox, sdf_scale, num_points, which):
        """Field-guided sampling: each cascade probe runs the two kernels.
        The sampler's sdf is unclamped; only the selected values are clamped."""
        c = self.cfg
        decoder = self.hand_sdf_decoder if which == "hand" else self.obj_sdf_decoder
        weights = prepare_weights(fold_weight_norm(decoder), self.compute_dtype)

        def sdf_fn(pts):  # [B, M, 3] -> [B, M]
            flat = self._sdf_decoder_inputs(pyramid, pts, center, cam_intr, sdf_scale)
            return sdf_mlp(flat, weights).reshape(pts.shape[0], pts.shape[1])

        levels = c.hier_levels
        if which == "obj" and c.hier_levels_obj is not None:
            levels = c.hier_levels_obj
        points, sdf = sdf_guided_sample_hierarchical(
            sdf_fn, center, cam_intr, bbox, sdf_scale=sdf_scale,
            num_points=num_points, bins_n=c.bins_n, levels=levels,
            clamp=c.clamping_distance,
        )
        return points, sdf, nerf_positional_encoding(points, c.nerf_num_freqs)

    def token_and_cross_queries(self, pyramid, hand_points, obj_points, mano_root,
                                obj_center, cam_intr):
        """Token features and the cross-field SDF queries off one merged
        [B, Ph+Po] pyramid gather (the cross queries sample at the same camera
        points as the tokens)."""
        c = self.cfg
        ph = hand_points.shape[1]
        hand_cam = scaled_to_cam(hand_points, mano_root, c.hand_sdf_scale)
        obj_cam = scaled_to_cam(obj_points, obj_center, c.obj_sdf_scale)
        merged_cam = torch.cat([hand_cam, obj_cam], dim=1)
        grid = pixels_to_grid(project_points(merged_cam, cam_intr), c.input_img_shape)
        feats = multiscale_point_features(pyramid, grid.contiguous(), c.multiscale_layers)
        feats = feats.to(self.compute_dtype)
        tok = self.linear_transformerin(feats)
        hand_fea, obj_fea = tok[:, :ph], tok[:, ph:]

        # The original's self-annotated "# bug": unscaled cross frames, kept
        # for checkpoint parity.
        hand_o_points = (hand_cam - obj_center[:, None, :]) * c.obj_sdf_scale
        obj_h_points = (obj_cam - mano_root[:, None, :]) * c.hand_sdf_scale
        cross_fea = self.linear_sdfin(feats)
        hand_o_posenc = nerf_positional_encoding(hand_o_points, c.nerf_num_freqs)
        obj_h_posenc = nerf_positional_encoding(obj_h_points, c.nerf_num_freqs)

        def cross_sdf(fea, posenc, pts, decoder):
            dec_in = torch.cat([fea.float(), posenc, pts], dim=-1).to(self.compute_dtype)
            sdf = decoder(dec_in.reshape(-1, dec_in.shape[-1]))
            sdf = sdf.reshape(*pts.shape[:2], 1).float()
            return torch.clamp(sdf, -c.clamping_distance, c.clamping_distance)

        hand_o_sdf = cross_sdf(cross_fea[:, :ph], hand_o_posenc, hand_o_points,
                               self.obj_sdf_decoder)
        obj_h_sdf = cross_sdf(cross_fea[:, ph:], obj_h_posenc, obj_h_points,
                              self.hand_sdf_decoder)
        return (hand_fea, obj_fea, hand_cam, obj_cam,
                hand_o_sdf, hand_o_posenc, obj_h_sdf, obj_h_posenc)

    # ---- full forward ------------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor], *, supervise_sdf: bool = True
                ) -> Dict[str, Any]:
        """Eval forward.  ``batch`` holds ``img`` [B,H,W,3] (NHWC, as the
        loaders give it), ``cam_intr``, ``mano_root``, ``obj_center_cam``,
        ``bbox_hand``, ``bbox_obj``, and with ``supervise_sdf`` the
        ``hand_sdf_points`` / ``obj_sdf_points`` to query."""
        c = self.cfg
        dt = self.compute_dtype
        out: Dict[str, Any] = {}
        mano_root, obj_center = batch["mano_root"], batch["obj_center_cam"]
        cam_intr = batch["cam_intr"]

        img = batch["img"].to(dt).permute(0, 3, 1, 2)  # a channels_last NCHW view
        img_feat, skips = self.backbone_net["resnet"](img)
        pyr, heads = self.decoder_net["resnet_decoder"](img_feat, skips)
        out["decoder_heads"] = heads.permute(0, 2, 3, 1).float()
        pyramid = {k: _nhwc(v) for k, v in pyr.items()}

        if supervise_sdf:
            out["hand_sdf_pred"] = self.sdf_forward(
                pyramid, batch["hand_sdf_points"], mano_root, cam_intr,
                c.hand_sdf_scale, "hand")
            out["obj_sdf_pred"] = self.sdf_forward(
                pyramid, batch["obj_sdf_points"], obj_center, cam_intr,
                c.obj_sdf_scale, "obj")

        hand_points, hand_sdf, hand_posenc = self.sdf_infer(
            pyramid, mano_root, cam_intr, batch["bbox_hand"], c.hand_sdf_scale,
            c.num_samp_hand, "hand")
        obj_points, obj_sdf, obj_posenc = self.sdf_infer(
            pyramid, obj_center, cam_intr, batch["bbox_obj"], c.obj_sdf_scale,
            c.num_samp_obj, "obj")
        sigma_hand = sdf_attention_weight(hand_sdf, self.hand_sigmoid_beta)
        sigma_obj = sdf_attention_weight(obj_sdf, self.obj_sigmoid_beta)

        (hand_fea, obj_fea, hand_cam, obj_cam, hand_o_sdf, hand_o_posenc,
         obj_h_sdf, obj_h_posenc) = self.token_and_cross_queries(
            pyramid, hand_points, obj_points, mano_root, obj_center, cam_intr)
        hand_points_notrans = hand_cam - mano_root[:, None, :]
        obj_points_notrans = obj_cam - obj_center[:, None, :]
        hand_o_points_notrans = hand_cam - obj_center[:, None, :]
        obj_h_points_notrans = obj_cam - mano_root[:, None, :]
        sigma_hand_o = sdf_attention_weight(hand_o_sdf, self.obj_sigmoid_beta)
        sigma_obj_h = sdf_attention_weight(obj_h_sdf, self.hand_sigmoid_beta)

        # Tokens: [xyz_rel ++ posenc ++ sigma * feat]
        hand_src = torch.cat([
            torch.cat([hand_points_notrans, hand_posenc, hand_fea * sigma_hand], -1),
            torch.cat([obj_h_points_notrans, obj_h_posenc, obj_fea * sigma_obj_h], -1),
        ], dim=1).to(dt)
        obj_src = torch.cat([
            torch.cat([obj_points_notrans, obj_posenc, obj_fea * sigma_obj], -1),
            torch.cat([hand_o_points_notrans, hand_o_posenc, hand_fea * sigma_hand_o], -1),
        ], dim=1).to(dt)

        hs, _memory, hand_enc_out, attn_wts = self.hand_transformer(
            hand_src, torch.zeros_like(hand_src), self.mano_query_embed.weight,
            self.tgt_mask, self.memory_mask)
        _obj_memory, obj_enc_out = self.obj_transformer(obj_src, torch.zeros_like(obj_src))

        hand_enc_hand = hand_enc_out[:, :, : c.num_samp_hand]
        out["hand_off"] = self.linear_handvote(hand_enc_hand).float()  # [L,B,P,60]
        out["hand_cls"] = self.linear_handcls(hand_enc_hand).float()  # [L,B,P,20]
        obj_enc_obj = obj_enc_out[:, :, : c.num_samp_obj]
        out["obj_rot"] = self.linear_obj_rot(obj_enc_obj).float()
        out["obj_trans"] = self.linear_obj_rel_trans(obj_enc_obj).float()
        out["mano_pose6d"] = self.linear_pose(hs[:, :, : c.mano_shape_indx]).float()
        out["mano_shape"] = self.linear_shape(hs[:, :, c.mano_shape_indx]).float()

        out["hand_points_notrans"] = hand_points_notrans
        out["hand_points"] = hand_points
        out["obj_points"] = obj_points
        out["hand_sdf"] = hand_sdf
        out["obj_sdf"] = obj_sdf
        out["attn_wts"] = attn_wts
        return out


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``, drawn like the JAX package's flax
    initializers: lecun-normal convs and dense layers with zero biases,
    identity BatchNorm, weight-norm directions N(0, 0.01) with unit gains,
    xavier-uniform packed qkv, N(0, 1) MANO queries."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) or \
                isinstance(m, nn.Linear) else m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, WeightNormLinear):
            m.weight_v.normal_(0.0, 0.01, generator=g)
            m.weight_g.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            c = m.d_model
            a = math.sqrt(6.0 / (c + 3 * c))
            m.in_proj_weight.uniform_(-a, a, generator=g)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=g)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    return model


def build_model(cfg: Config, seed: int = 0) -> HOISDF:
    """The model with random weights from ``seed``, on the CPU."""
    return init_weights(HOISDF(cfg), seed).eval()
