"""HOISDF: global-SDF-guided hand+object pose estimation
(``hoisdf_tpu/models/hoisdf.py``).

Token points come from the field-guided sampler (eval, and the field-guided
train steps) or, with ``use_presampled``, from the batch's ground-truth-near
points jittered uniformly in +-``dist_range`` (the other train steps).  The
sampler is ``sdf_infer_mode``'s ("hier" by default, "coarse2fine" or the
dense "full" scan), per field, or with ``paired_sdf_infer`` one grouped
"hier" cascade for both fields (``models/experimental.py``); its probes
gather bilinearly, or with ``infer_gather_nearest`` the nearest texel.  Token
features and cross-field queries share one merged pyramid gather
(``merged_field_queries=True``) or take four, the cross queries through
``sdf_forward``.  The ho3d preset's pyramid comes from ``DecoderBig`` (3,968
channels at ResNet-50), and ho3d_render's transformer decodes one shape query
(the eval step solves the pose by IK from the voted joints,
``train.solve_hand_ik`` over ``ops/ik.py``).  The module's
mode is the train flag: ``model.train()`` puts
BatchNorm on batch statistics and turns dropout on, whose masks (and the
jitter) come from the ``generator`` passed to ``forward``.  Module and
parameter names are the original PyTorch HOISDF's; the dead heads
``linear_objvote`` / ``linear_objcls`` and the unused ``norm1`` are left out,
as in the JAX package.

The two hot kernels run here: every cascade probe gathers its pyramid
features through ``gather_lerp`` and scores them through ``sdf_mlp``; the
supervised SDF queries and the token gather differentiate through
``gather_lerp``'s backward kernel.  The sampler runs without gradients and
without dropout in every mode (the JAX package's kernel route; its CPU route
applies the decoder's dropout inside the sampler in train mode).

While a ``torch.profiler`` runs, ``forward`` records its stages as spans
(``utils/profiling.py``), shared by the eval and train steps:
``model.backbone``, ``model.decoder``, ``model.sdf_supervise``,
``model.sampler`` (field-guided or presampled), ``model.field_queries``,
``model.tokens``, ``model.transformers`` and ``model.heads``.

The inference forward on a card replays one CUDA graph of those stages per
batch signature (``models/forward_graph.py``): its replay records
``model.graph`` instead of the stages' spans.  The train steps, the
presampled branch, ``torch.export`` and FSDP take the same code eagerly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from hoisdf_torch.config import Config
from hoisdf_torch.models import forward_graph
from hoisdf_torch.models.decoder import Decoder, DecoderBig
from hoisdf_torch.models.experimental import paired_sdf_infer
from hoisdf_torch.models.layers import Linear
from hoisdf_torch.models.resnet import ResNetBackbone
from hoisdf_torch.models.sdf_decoder import SDFDecoder, WeightNormLinear
from hoisdf_torch.models.transformer import (
    MultiheadAttention,
    Transformer,
    VoteTransformer,
    get_mano_memory_mask,
    get_mano_tgt_mask,
    get_manoshape_memory_mask,
)
from hoisdf_torch.ops.grid_sample import (
    multiscale_point_features,
    pixels_to_grid,
    project_points,
)
from hoisdf_torch.ops.kernels import graph_counts
from hoisdf_torch.ops.kernels.sdf_mlp import fold_weight_norm, prepare_weights, sdf_mlp
from hoisdf_torch.ops.nerf import nerf_positional_encoding
from hoisdf_torch.ops.point_sampling import (
    scaled_to_cam,
    sdf_guided_sample,
    sdf_guided_sample_coarse2fine,
    sdf_guided_sample_hierarchical,
)
from hoisdf_torch.parallel.zero import unsharded
from hoisdf_torch.utils.profiling import span


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
        decoder = (DecoderBig if c.use_big_decoder else Decoder)(backbone.skip_channels)
        self.decoder_net = nn.ModuleDict({"resnet_decoder": decoder})
        self.hand_sdf_decoder = SDFDecoder(c.hidden_dim, c.point_feat_size,
                                           use_classifier=c.classifier_branch,
                                           num_class=c.num_class)
        self.obj_sdf_decoder = SDFDecoder(c.hidden_dim, c.point_feat_size,
                                          use_classifier=c.classifier_branch,
                                          num_class=c.num_class)
        self.hand_transformer = Transformer(c.hidden_dim, c.nheads, c.enc_layers,
                                           c.dec_layers, c.dim_feedforward, c.dropout)
        self.obj_transformer = VoteTransformer(c.hidden_dim, c.nheads, c.enc_layers // 2,
                                               c.dim_feedforward, c.dropout)
        # cfg.multiscale_dim at ResNet-50; DecoderBig's top level is the
        # backbone's own stride32 map, narrower under a smaller ResNet
        ms = sum(decoder.out_channels[name] for name in c.multiscale_layers)
        hd = c.hidden_dim
        self.linear_transformerin = MLP(ms, (1024, 512, 256, hd - c.point_feat_size),
                                        relu_last=True)
        self.linear_sdfin = MLP(ms, (512, hd), relu_last=True)
        self.hand_sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.obj_sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        # ho3d_render's IK head: one shape query, joints from the votes by IK
        ik = c.use_inverse_kinematics
        self.mano_query_embed = nn.Embedding(1 if ik else c.mano_num_queries, hd)
        if not ik:
            self.linear_pose = MLP(hd, (hd, hd, 6))
        self.linear_shape = MLP(hd, (hd, hd, 10))
        self.linear_handvote = MLP(hd, (hd, hd, hd, 20 * 3))
        self.linear_handcls = MLP(hd, (hd, hd, 20))
        self.linear_obj_rel_trans = MLP(hd, (hd, hd, 3))
        self.linear_obj_rot = MLP(hd, (hd, hd, 3))
        if ik:
            tgt_mask = None
            memory_mask = get_manoshape_memory_mask(c.num_samp_hand, c.num_samp_obj)
        else:
            tgt_mask = get_mano_tgt_mask(c.mano_num_queries, c.mano_shape_indx)
            memory_mask = get_mano_memory_mask(c.mano_num_queries, c.num_samp_hand,
                                               c.num_samp_obj)
        self.register_buffer("tgt_mask", tgt_mask, persistent=False)
        self.register_buffer("memory_mask", memory_mask, persistent=False)

    # ---- field queries -----------------------------------------------------

    def _gather_grid(self, points_scaled, center, cam_intr, sdf_scale):
        cam_pts = points_scaled / sdf_scale + center[:, None, :]
        grid = pixels_to_grid(project_points(cam_pts, cam_intr), self.cfg.input_img_shape)
        return grid.contiguous(), cam_pts

    def point_transformer_features(self, pyramid, points_scaled, center, cam_intr, sdf_scale):
        """Token features [B, P, hidden - point_feat_size] and the camera
        points, off one pyramid gather (the non-merged field queries)."""
        grid, cam_pts = self._gather_grid(points_scaled, center, cam_intr, sdf_scale)
        feats = multiscale_point_features(pyramid, grid, self.cfg.multiscale_layers)
        return self.linear_transformerin(feats.to(self.compute_dtype)), cam_pts

    def _sdf_decoder_inputs(self, pyramid, points_scaled, center, cam_intr, sdf_scale,
                            nearest: bool = False):
        """Flat [B*P, in] decoder inputs (pixel feature ++ posenc ++ xyz)."""
        grid, _ = self._gather_grid(points_scaled, center, cam_intr, sdf_scale)
        return self._decoder_rows(pyramid, grid, points_scaled, nearest)

    def _decoder_rows(self, pyramid, grid, points_scaled, nearest: bool = False):
        """[B*P, in] decoder inputs from the gather at ``grid`` [B,P,2]."""
        c = self.cfg
        feats = multiscale_point_features(pyramid, grid, c.multiscale_layers, nearest=nearest)
        points_fea = self.linear_sdfin(feats.to(self.compute_dtype))
        posenc = nerf_positional_encoding(points_scaled, c.nerf_num_freqs)
        dec_in = torch.cat([points_fea.float(), posenc, points_scaled], dim=-1)
        return dec_in.to(self.compute_dtype).reshape(-1, dec_in.shape[-1])

    def sdf_forward(self, pyramid, points_scaled, center, cam_intr, sdf_scale, which,
                    generator: Optional[torch.Generator] = None):
        """Clamped SDF at arbitrary scaled-frame points -> (sdf [B, P, 1] f32,
        part-class logits [B, P, num_class] or None)."""
        flat = self._sdf_decoder_inputs(pyramid, points_scaled, center, cam_intr, sdf_scale)
        decoder = self.hand_sdf_decoder if which == "hand" else self.obj_sdf_decoder
        sdf, logits = decoder(flat, generator)
        sdf = sdf.reshape(*points_scaled.shape[:2], 1).float()
        c = self.cfg.clamping_distance
        if logits is not None:
            logits = logits.reshape(*points_scaled.shape[:2], -1)
        return torch.clamp(sdf, -c, c), logits

    @torch.no_grad()
    def sdf_infer(self, pyramid, center, cam_intr, bbox, sdf_scale, num_points, which):
        """Field-guided sampling in ``sdf_infer_mode``, without gradients:
        each probe runs the two kernels (the gather in its nearest mode with
        ``infer_gather_nearest``, on every device, as the JAX package's
        kernel route).  The sampler's sdf is unclamped; only the selected
        values are clamped."""
        c = self.cfg
        decoder = self.hand_sdf_decoder if which == "hand" else self.obj_sdf_decoder

        def sdf_fn(pts):  # [B, M, 3] -> [B, M]
            flat = self._sdf_decoder_inputs(pyramid, pts, center, cam_intr, sdf_scale,
                                            nearest=c.infer_gather_nearest)
            return sdf_mlp(flat, weights).reshape(pts.shape[0], pts.shape[1])

        common = dict(sdf_scale=sdf_scale, num_points=num_points, bins_n=c.bins_n,
                      clamp=c.clamping_distance)
        # the kernel reads the decoder's weights outside its forward: under
        # FSDP they are gathered for the whole sampler
        with unsharded(decoder):
            weights = prepare_weights(fold_weight_norm(decoder), self.compute_dtype)
            if c.sdf_infer_mode == "coarse2fine":
                points, sdf = sdf_guided_sample_coarse2fine(
                    sdf_fn, center, cam_intr, bbox, coarse_factor=c.bins_n // c.coarse_bins,
                    keep_cells=c.coarse_keep_cells, **common)
            elif c.sdf_infer_mode == "hier":
                levels = c.hier_levels
                if which == "obj" and c.hier_levels_obj is not None:
                    levels = c.hier_levels_obj
                points, sdf = sdf_guided_sample_hierarchical(
                    sdf_fn, center, cam_intr, bbox, levels=levels, **common)
            else:
                points, sdf = sdf_guided_sample(
                    sdf_fn, center, cam_intr, bbox, chunk=c.sdf_infer_chunk, **common)
        return points, sdf, nerf_positional_encoding(points, c.nerf_num_freqs)

    def token_and_cross_queries(self, pyramid, hand_points, obj_points, mano_root,
                                obj_center, cam_intr,
                                generator: Optional[torch.Generator] = None):
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
            sdf, _ = decoder(dec_in.reshape(-1, dec_in.shape[-1]), generator)
            sdf = sdf.reshape(*pts.shape[:2], 1).float()
            return torch.clamp(sdf, -c.clamping_distance, c.clamping_distance)

        hand_o_sdf = cross_sdf(cross_fea[:, :ph], hand_o_posenc, hand_o_points,
                               self.obj_sdf_decoder)
        obj_h_sdf = cross_sdf(cross_fea[:, ph:], obj_h_posenc, obj_h_points,
                              self.hand_sdf_decoder)
        return (hand_fea, obj_fea, hand_cam, obj_cam,
                hand_o_sdf, hand_o_posenc, obj_h_sdf, obj_h_posenc)

    # ---- full forward ------------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor], *, supervise_sdf: bool = True,
                use_presampled: bool = False, dist_range: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Forward in the module's mode.  ``batch`` holds ``img`` [B,H,W,3]
        (NHWC, as the loaders give it), ``cam_intr``, ``mano_root``,
        ``obj_center_cam``, ``bbox_hand``, ``bbox_obj``, with
        ``supervise_sdf`` the ``hand_sdf_points`` / ``obj_sdf_points`` to
        query, and with ``use_presampled`` the ``hand_pre_points`` /
        ``obj_pre_points`` to jitter.  ``generator`` (on the batch's device)
        draws the jitter and the dropout masks.

        On a card, in eval mode, without gradients, on field-guided points,
        untraced and unsharded (``forward_graph.on_card``, ``untraced`` and
        ``graphs_of``), the forward replays a CUDA graph of
        :meth:`eager_forward` per batch signature and returns clones of its
        outputs; anything else runs :meth:`eager_forward`."""
        graphs = None
        if not (self.training or use_presampled) and forward_graph.on_card(batch) \
                and forward_graph.untraced():
            graphs = forward_graph.graphs_of(self)
        if graphs is None:
            graph_counts["eager"] += 1
            return self.eager_forward(batch, supervise_sdf=supervise_sdf,
                                      use_presampled=use_presampled, dist_range=dist_range,
                                      generator=generator)
        key = (supervise_sdf, self.compute_dtype, id(self.cfg),
               torch.is_inference_mode_enabled(),
               *((k, v.shape, v.stride(), v.dtype, v.device) for k, v in batch.items()))
        return graphs.run(key, batch, lambda b: self.eager_forward(b, supervise_sdf=supervise_sdf))

    def eager_forward(self, batch: Dict[str, torch.Tensor], *, supervise_sdf: bool = True,
                      use_presampled: bool = False, dist_range: float = 0.0,
                      generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """:meth:`forward`'s body, launched op by op."""
        c = self.cfg
        dt = self.compute_dtype
        out: Dict[str, Any] = {}
        mano_root, obj_center = batch["mano_root"], batch["obj_center_cam"]
        cam_intr = batch["cam_intr"]

        with span("model.backbone"):
            img = batch["img"].to(dt).permute(0, 3, 1, 2)  # a channels_last NCHW view
            img_feat, skips = self.backbone_net["resnet"](img)
        with span("model.decoder"):
            pyr, heads = self.decoder_net["resnet_decoder"](img_feat, skips)
            out["decoder_heads"] = heads.permute(0, 2, 3, 1).float()
            pyramid = {k: _nhwc(v) for k, v in pyr.items()}

        if supervise_sdf:
            with span("model.sdf_supervise"):
                out["hand_sdf_pred"], hand_logits = self.sdf_forward(
                    pyramid, batch["hand_sdf_points"], mano_root, cam_intr,
                    c.hand_sdf_scale, "hand", generator)
                out["obj_sdf_pred"], obj_logits = self.sdf_forward(
                    pyramid, batch["obj_sdf_points"], obj_center, cam_intr,
                    c.obj_sdf_scale, "obj", generator)
                if hand_logits is not None:
                    out["hand_cls_logits"] = hand_logits.float()
                    out["obj_cls_logits"] = obj_logits.float()

        with span("model.sampler"):
            if use_presampled:
                def jitter(pts):  # uniform in [-dist_range, dist_range)
                    u = torch.rand(pts.shape, generator=generator, device=pts.device)
                    return pts + (u * 2.0 - 1.0) * dist_range

                hand_points = jitter(batch["hand_pre_points"])
                obj_points = jitter(batch["obj_pre_points"])
                hand_sdf, _ = self.sdf_forward(pyramid, hand_points, mano_root, cam_intr,
                                               c.hand_sdf_scale, "hand", generator)
                obj_sdf, _ = self.sdf_forward(pyramid, obj_points, obj_center, cam_intr,
                                              c.obj_sdf_scale, "obj", generator)
                hand_posenc = nerf_positional_encoding(hand_points, c.nerf_num_freqs)
                obj_posenc = nerf_positional_encoding(obj_points, c.nerf_num_freqs)
            elif c.sdf_infer_mode == "hier" and c.paired_sdf_infer:
                (hand_points, hand_sdf, hand_posenc), (obj_points, obj_sdf, obj_posenc) = \
                    paired_sdf_infer(self, pyramid, mano_root, obj_center, cam_intr,
                                     batch["bbox_hand"], batch["bbox_obj"])
            else:
                hand_points, hand_sdf, hand_posenc = self.sdf_infer(
                    pyramid, mano_root, cam_intr, batch["bbox_hand"], c.hand_sdf_scale,
                    c.num_samp_hand, "hand")
                obj_points, obj_sdf, obj_posenc = self.sdf_infer(
                    pyramid, obj_center, cam_intr, batch["bbox_obj"], c.obj_sdf_scale,
                    c.num_samp_obj, "obj")
        sigma_hand = sdf_attention_weight(hand_sdf.detach(), self.hand_sigmoid_beta)
        sigma_obj = sdf_attention_weight(obj_sdf.detach(), self.obj_sigmoid_beta)

        with span("model.field_queries"):
            if c.merged_field_queries:
                (hand_fea, obj_fea, hand_cam, obj_cam, hand_o_sdf, hand_o_posenc,
                 obj_h_sdf, obj_h_posenc) = self.token_and_cross_queries(
                    pyramid, hand_points, obj_points, mano_root, obj_center, cam_intr,
                    generator)
            else:
                hand_fea, hand_cam = self.point_transformer_features(
                    pyramid, hand_points, mano_root, cam_intr, c.hand_sdf_scale)
                obj_fea, obj_cam = self.point_transformer_features(
                    pyramid, obj_points, obj_center, cam_intr, c.obj_sdf_scale)
                # the cross queries through the other field's decoder, each at
                # its own gather (the original's "# bug" frames, as merged)
                hand_o_points = (hand_cam - obj_center[:, None, :]) * c.obj_sdf_scale
                hand_o_sdf, _ = self.sdf_forward(pyramid, hand_o_points, obj_center, cam_intr,
                                                 c.obj_sdf_scale, "obj", generator)
                hand_o_posenc = nerf_positional_encoding(hand_o_points, c.nerf_num_freqs)
                obj_h_points = (obj_cam - mano_root[:, None, :]) * c.hand_sdf_scale
                obj_h_sdf, _ = self.sdf_forward(pyramid, obj_h_points, mano_root, cam_intr,
                                                c.hand_sdf_scale, "hand", generator)
                obj_h_posenc = nerf_positional_encoding(obj_h_points, c.nerf_num_freqs)

        with span("model.tokens"):
            hand_points_notrans = hand_cam - mano_root[:, None, :]
            obj_points_notrans = obj_cam - obj_center[:, None, :]
            hand_o_points_notrans = hand_cam - obj_center[:, None, :]
            obj_h_points_notrans = obj_cam - mano_root[:, None, :]
            sigma_hand_o = sdf_attention_weight(hand_o_sdf.detach(), self.obj_sigmoid_beta)
            sigma_obj_h = sdf_attention_weight(obj_h_sdf.detach(), self.hand_sigmoid_beta)

            # Tokens: [xyz_rel ++ posenc ++ sigma * feat]; the other field's
            # tokens carry no gradient
            hand_src = torch.cat([
                torch.cat([hand_points_notrans, hand_posenc, hand_fea * sigma_hand], -1),
                torch.cat([obj_h_points_notrans, obj_h_posenc, obj_fea * sigma_obj_h],
                          -1).detach(),
            ], dim=1).to(dt)
            obj_src = torch.cat([
                torch.cat([obj_points_notrans, obj_posenc, obj_fea * sigma_obj], -1),
                torch.cat([hand_o_points_notrans, hand_o_posenc, hand_fea * sigma_hand_o],
                          -1).detach(),
            ], dim=1).to(dt)

        with span("model.transformers"):
            hs, _memory, hand_enc_out, attn_wts = self.hand_transformer(
                hand_src, torch.zeros_like(hand_src), self.mano_query_embed.weight,
                self.tgt_mask, self.memory_mask, generator=generator)
            _obj_memory, obj_enc_out = self.obj_transformer(
                obj_src, torch.zeros_like(obj_src), generator=generator)

        with span("model.heads"):
            hand_enc_hand = hand_enc_out[:, :, : c.num_samp_hand]
            out["hand_off"] = self.linear_handvote(hand_enc_hand).float()  # [L,B,P,60]
            out["hand_cls"] = self.linear_handcls(hand_enc_hand).float()  # [L,B,P,20]
            obj_enc_obj = obj_enc_out[:, :, : c.num_samp_obj]
            out["obj_rot"] = self.linear_obj_rot(obj_enc_obj).float()
            out["obj_trans"] = self.linear_obj_rel_trans(obj_enc_obj).float()
            if c.use_inverse_kinematics:
                out["mano_shape"] = self.linear_shape(hs[:, :, 0]).float()  # [L,B,10]
            else:
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
