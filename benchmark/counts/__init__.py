"""The benchmark's own counts: the card's peaks, the work of each kernel
launch that a configuration's shapes need, and the FLOPs of a step.

A kernel's bound is the larger of its operations over the peak FLOP/s and
its bytes over the peak bandwidth, each input byte read once and each output
byte written once, whatever the kernel reads again.  The launches are those
that the configuration's shapes need: the cascade's probe rows, the
pyramid's texels and the points.  A kernel that a later change pads or
splits does not change them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM5 (80 GB HBM3), dense, from NVIDIA's data sheet: bf16 on
# the tensor cores, f32 on the CUDA cores (TF32 off), HBM3 bandwidth.  The
# rates assume the card's full 700 W; a run prints the card's limit beside.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12, "bytes": 3.35e12},
}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card named ``device_name`` (KeyError if unknown: a
    roofline against another card's peak would read wrong)."""
    return PEAKS[device_name]


# ---- shapes of the configuration ------------------------------------------------

def pyramid_shapes(cfg) -> List[Tuple[int, int, int]]:
    """(H, W, C) of each pyramid level the gather reads, at the input size."""
    h, w = cfg.input_img_shape
    strides = {"stride2": 2, "stride4": 4, "stride8": 8, "stride16": 16, "stride32": 32}
    if cfg.use_big_decoder:
        chans = {"stride2": 128, "stride4": 256, "stride8": 512, "stride16": 1024,
                 "stride32": 2048}
    else:
        chans = {"stride2": 32, "stride4": 64, "stride8": 128, "stride16": 256,
                 "stride32": 512}
    return [(h // strides[n], w // strides[n], chans[n]) for n in cfg.multiscale_layers]


def mlp_layers(cfg) -> List[Tuple[int, int]]:
    """(in, out) of the SDF decoder's five products, the skip concat
    widening layer 2."""
    d = cfg.hidden_dim + cfg.point_feat_size
    return [(d, 512), (512, 512 - d), (512, 512), (512, 512), (512, 1)]


def cascade_rows(cfg, levels) -> List[int]:
    """Probe points per frame of each stage of the "hier" cascade: every
    first-level cell, then each kept cell's children, then every lattice
    point of the last level's kept cells."""
    rows = [(cfg.bins_n // levels[0][0]) ** 3]
    for (pf, keep), (cf, _) in zip(levels[:-1], levels[1:]):
        rows.append(keep * (pf // cf) ** 3)
    rows.append(levels[-1][1] * levels[-1][0] ** 3)
    return rows


def sampler_rows(cfg) -> List[int]:
    """Rows per frame of each launch of kernel A in one field-guided
    forward: the hand cascade's stages, then the object's."""
    obj_levels = cfg.hier_levels_obj if cfg.hier_levels_obj is not None else cfg.hier_levels
    return cascade_rows(cfg, cfg.hier_levels) + cascade_rows(cfg, obj_levels)


# ---- kernel bounds -------------------------------------------------------------------

def sdf_mlp_bound_s(cfg, rows: int, dtype: str, pk: Dict[str, float]) -> float:
    """Kernel A on ``rows`` rows: 2 x rows x sum(in x out) operations; bytes:
    the rows in and one f32 a row out, the weights once."""
    layers = mlp_layers(cfg)
    flops = 2 * rows * sum(a * b for a, b in layers)
    nbytes = (rows * layers[0][0] * DTYPE_BYTES[dtype] + rows * 4
              + sum(a * b + b for a, b in layers) * DTYPE_BYTES[dtype])
    return max(flops / pk[dtype], nbytes / pk["bytes"])


def gather_bound_s(cfg, batch: int, points: int, dtype: str, pk: Dict[str, float]) -> float:
    """Kernel B: the whole pyramid read once, the f32 grid, the [B, P, sum C]
    output written once (no operations counted: bytes bound it)."""
    levels = pyramid_shapes(cfg)
    c = sum(ch for _, _, ch in levels)
    texels = sum(h * w * ch for h, w, ch in levels)
    nbytes = (batch * texels * DTYPE_BYTES[dtype] + batch * points * 2 * 4
              + batch * points * c * DTYPE_BYTES[dtype])
    return nbytes / pk["bytes"]


def gather_bwd_bound_s(cfg, batch: int, points: int, pk: Dict[str, float]) -> float:
    """Kernel B's backward (f32): the output gradient [B, P, sum C] and the
    grid read once, the pyramid's f32 gradient written once."""
    levels = pyramid_shapes(cfg)
    c = sum(ch for _, _, ch in levels)
    texels = sum(h * w * ch for h, w, ch in levels)
    return (batch * points * c * 4 + batch * points * 2 * 4 + batch * texels * 4) / pk["bytes"]


def eval_step_bounds(cfg, batch: int, pk: Dict[str, float], supervise: bool) -> Dict[str, float]:
    """The bounds of one eval step's launches, summed per kernel."""
    dt = cfg.compute_dtype
    a = sum(sdf_mlp_bound_s(cfg, batch * r, dt, pk) for r in sampler_rows(cfg))
    b = sum(gather_bound_s(cfg, batch, r, dt, pk) for r in sampler_rows(cfg))
    if supervise:
        b += gather_bound_s(cfg, batch, cfg.num_samp_hand, dt, pk)
        b += gather_bound_s(cfg, batch, cfg.num_samp_obj, dt, pk)
    b += gather_bound_s(cfg, batch, cfg.num_samp_hand + cfg.num_samp_obj, dt, pk)
    return {"sdf_mlp": a, "gather_lerp": b}


def eval_step_launches(cfg, supervise: bool) -> Dict[str, int]:
    n = len(sampler_rows(cfg))
    return {"sdf_mlp": n, "gather_lerp": n + (2 if supervise else 0) + 1}


def train_step_bounds(cfg, batch: int, pk: Dict[str, float], field_guided: bool
                      ) -> Dict[str, float]:
    """The bounds of one f32 train step's launches of A (the sampler's, in a
    field-guided step) and of B's backward (the supervised queries and the
    token gather)."""
    a = (sum(sdf_mlp_bound_s(cfg, batch * r, "float32", pk) for r in sampler_rows(cfg))
         if field_guided else 0.0)
    bwd = sum(gather_bwd_bound_s(cfg, batch, p, pk)
              for p in (cfg.num_samp_hand, cfg.num_samp_obj,
                        cfg.num_samp_hand + cfg.num_samp_obj))
    return {"sdf_mlp": a, "gather_lerp_bwd": bwd}
