"""Multi-level bilinear feature gather: the CUDA kernel ``csrc/gather_lerp.cu``
and its plain PyTorch version.

Counterpart of ``hoisdf_tpu/ops/pallas/gather_lerp.py::fused_gather_lerp3``,
widened to the whole pyramid, and of the gather-and-lerp of
``hoisdf_tpu/ops/grid_sample.py::grid_sample_bilinear``: torch
``grid_sample(padding_mode="border", align_corners=True)`` semantics on NHWC
maps, lerp in f32, result in the maps' type.  Forward only.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from hoisdf_torch.ops.kernels import launch_counts
from hoisdf_torch.ops.kernels.build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 5


def grid_sample_bilinear(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` [B,H,W,C] at normalized coords ``grid`` [B,P,2] -> [B,P,C].

    grid[..., 0] is x across W, grid[..., 1] is y across H; -1 maps to 0 and 1
    to size-1 (align_corners); out-of-range coordinates clamp to the border
    before the corners are taken."""
    b, h, w, c = feat.shape
    x = torch.clamp((grid[..., 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    y = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = feat.reshape(b, h * w, c)

    def corner(yi, xi):
        idx = (yi.long() * w + xi.long())[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx).float()

    top = corner(y0, x0) * (1 - wx) + corner(y0, x1) * wx
    bot = corner(y1, x0) * (1 - wx) + corner(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(feat.dtype)


def gather_lerp_plain(grid: torch.Tensor, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level bilinear sample, channel-concatenated: [B, P, sum C]."""
    return torch.cat([grid_sample_bilinear(f, grid) for f in feats], dim=-1)


def gather_lerp(grid: torch.Tensor, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bilinear-sample up to five NHWC levels at ``grid`` [B,P,2] (f32) and
    channel-concatenate -> [B, P, sum C] in the maps' type (f32 or bf16).
    CPU tensors take :func:`gather_lerp_plain`."""
    if grid.device.type == "cpu":
        return gather_lerp_plain(grid, feats)
    if grid.device.type != "cuda":
        raise ValueError(f"gather_lerp: unsupported device {grid.device}")
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"gather_lerp: takes 1 to {MAX_LEVELS} levels, got {len(feats)}")
    if grid.dtype != torch.float32 or grid.dim() != 3 or grid.shape[-1] != 2 \
            or not grid.is_contiguous():
        raise ValueError(f"gather_lerp: grid must be contiguous f32 [B,P,2], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    b, p, _ = grid.shape
    if b > 65535:  # images ride the launch grid's y axis
        raise ValueError(f"gather_lerp: batch {b} exceeds 65535")
    dtype = feats[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"gather_lerp: map dtype {dtype} not in {list(_DTYPES)}")
    for f in feats:
        if f.device != grid.device or f.dtype != dtype or f.dim() != 4 \
                or f.shape[0] != b or not f.is_contiguous():
            raise ValueError(
                "gather_lerp: maps must be contiguous NHWC tensors of one dtype on "
                f"the grid's device with batch {b}; got {f.dtype} {tuple(f.shape)} "
                f"contiguous={f.is_contiguous()} on {f.device}")
    c_total = sum(f.shape[3] for f in feats)
    out = torch.empty((b, p, c_total), dtype=dtype, device=grid.device)
    if b * p == 0:
        return out
    lib = library()
    ptrs = (ctypes.c_void_p * len(feats))(*[f.data_ptr() for f in feats])
    dims = (ctypes.c_int * (3 * len(feats)))(
        *[d for f in feats for d in (f.shape[1], f.shape[2], f.shape[3])])
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        rc = lib.gather_lerp_launch(grid.data_ptr(), b, p, len(feats), ptrs, dims,
                                    _DTYPES[dtype], out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_lerp kernel launch failed with CUDA error {rc}")
    launch_counts["gather_lerp"] += 1
    return out
