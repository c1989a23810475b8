"""Multi-level bilinear feature gather and its backward: the CUDA kernels of
``csrc/gather_lerp.cu`` and their plain PyTorch versions.

The forward is the counterpart of
``hoisdf_tpu/ops/pallas/gather_lerp.py::fused_gather_lerp3``, widened to the
whole pyramid, and of the gather-and-lerp of
``hoisdf_tpu/ops/grid_sample.py::grid_sample_bilinear``: torch
``grid_sample(padding_mode="border", align_corners=True)`` semantics on NHWC
maps, lerp in f32, result in the maps' type.  The backward is
``grid_sample.py::_gsb_fast_bwd``: the 4-corner scatter-add of the output
gradient into d/dfeat, accumulated in f32, and no gradient for the grid (every
caller samples at a detached grid).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from hoisdf_torch.ops.kernels import launch_counts
from hoisdf_torch.ops.kernels.build import BWD_COPIES_BYTES, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 5


def grid_sample_bilinear(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` [B,H,W,C] at normalized coords ``grid`` [B,P,2] -> [B,P,C].

    grid[..., 0] is x across W, grid[..., 1] is y across H; -1 maps to 0 and 1
    to size-1 (align_corners); out-of-range coordinates clamp to the border
    before the corners are taken."""
    b, h, w, c = feat.shape
    x0, x1, y0, y1, wx, wy = _corners(grid, h, w)
    wx, wy = wx[..., None], wy[..., None]
    flat = feat.reshape(b, h * w, c)

    def corner(yi, xi):
        idx = (yi * w + xi)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx).float()

    top = corner(y0, x0) * (1 - wx) + corner(y0, x1) * wx
    bot = corner(y1, x0) * (1 - wx) + corner(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(feat.dtype)


def _corners(grid: torch.Tensor, h: int, w: int):
    """Corner indices (long) and lerp weights of ``grid`` [B,P,2] on an
    h x w map: x0, x1, y0, y1, wx, wy, each [B,P]."""
    x = torch.clamp((grid[..., 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    y = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    return x0.long(), x1.long(), y0.long(), y1.long(), x - x0, y - y0


def gather_lerp_plain(grid: torch.Tensor, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level bilinear sample, channel-concatenated: [B, P, sum C]."""
    return torch.cat([grid_sample_bilinear(f, grid) for f in feats], dim=-1)


def gather_lerp_bwd_plain(grid: torch.Tensor, g: torch.Tensor,
                          shapes: Sequence[Tuple[int, int, int]], dtype: torch.dtype
                          ) -> List[torch.Tensor]:
    """d/dfeat of :func:`gather_lerp_plain` for the output gradient ``g``
    [B,P,sum C]: per level (H, W, C) of ``shapes``, the 4-corner
    ``index_add_`` of g * weight into an f32 [B,H,W,C], cast to ``dtype``."""
    b, p = grid.shape[:2]
    out, off = [], 0
    bidx = torch.arange(b, device=grid.device)[:, None]
    for h, w, c in shapes:
        x0, x1, y0, y1, wx, wy = _corners(grid, h, w)
        gl = g[..., off:off + c].float()
        acc = torch.zeros(b * h * w, c, dtype=torch.float32, device=grid.device)
        for yi, xi, wgt in ((y0, x0, (1 - wx) * (1 - wy)), (y0, x1, wx * (1 - wy)),
                            (y1, x0, (1 - wx) * wy), (y1, x1, wx * wy)):
            idx = (bidx * (h * w) + yi * w + xi).reshape(-1)
            acc.index_add_(0, idx, (gl * wgt[..., None]).reshape(-1, c))
        out.append(acc.reshape(b, h, w, c).to(dtype))
        off += c
    return out


def _check_grid(grid: torch.Tensor, name: str) -> Tuple[int, int]:
    if grid.dtype != torch.float32 or grid.dim() != 3 or grid.shape[-1] != 2 \
            or not grid.is_contiguous():
        raise ValueError(f"{name}: grid must be contiguous f32 [B,P,2], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    b, p, _ = grid.shape
    if b > 65535:  # images ride the launch grid's y axis
        raise ValueError(f"{name}: batch {b} exceeds 65535")
    return b, p


# The backward's plan (csrc/gather_lerp.cu): a level with at most
# BWD_SHARED_MAX_CELLS cells per image, where an image's points crowd onto a
# few cells, takes the shared route, in blocks of BWD_SLICE channels (the
# last block of a level may be narrower), each with as many private copies of
# the slice's map, up to 16 (one per group of 16 lanes), as fit in
# BWD_COPIES_BYTES; the other levels take the global route.
BWD_SHARED_MAX_CELLS = 256
BWD_SLICE = 16


def bwd_plan(shapes: Sequence[Tuple[int, int, int]]) -> Tuple[Tuple[int, int], ...]:
    """Per level (H, W, C): (channels per block, copies per block) of the
    shared route, or (0, 0) for the global route."""
    plan = []
    for h, w, c in shapes:
        if h * w > BWD_SHARED_MAX_CELLS:
            plan.append((0, 0))
            continue
        s = min(c, BWD_SLICE)
        plan.append((s, max(1, min(16, BWD_COPIES_BYTES // (h * w * s * 4)))))
    return tuple(plan)


def gather_lerp_bwd(grid: torch.Tensor, g: torch.Tensor,
                    shapes: Sequence[Tuple[int, int, int]], dtype: torch.dtype
                    ) -> List[torch.Tensor]:
    """The backward of :func:`gather_lerp`: d/dfeat of every level (H, W, C)
    of ``shapes`` for the output gradient ``g`` [B,P,sum C], in ``dtype``.
    CPU tensors take :func:`gather_lerp_bwd_plain`.  On the card one launch
    covers every level, as :func:`bwd_plan` routes them: the shared route
    writes its levels whole in ``dtype``; the global route adds into a zeroed
    f32 buffer of its levels alone, cast to ``dtype`` after.  Only the global
    route adds with atomics: its levels are not bitwise repeatable, the shared
    route's are."""
    if grid.device.type == "cpu":
        return gather_lerp_bwd_plain(grid, g, shapes, dtype)
    if grid.device.type != "cuda":
        raise ValueError(f"gather_lerp_bwd: unsupported device {grid.device}")
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"gather_lerp_bwd: takes 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    b, p = _check_grid(grid, "gather_lerp_bwd")
    c_total = sum(s[2] for s in shapes)
    if g.device != grid.device or g.dtype not in _DTYPES or tuple(g.shape) != (b, p, c_total) \
            or not g.is_contiguous():
        raise ValueError(f"gather_lerp_bwd: g must be a contiguous f32 or bf16 [{b},{p},"
                         f"{c_total}] on {grid.device}, got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}")
    if dtype not in _DTYPES:
        raise TypeError(f"gather_lerp_bwd: map dtype {dtype} not in {list(_DTYPES)}")
    plan = bwd_plan(shapes)
    sizes = [b * h * w * c for (h, w, c), (sl, _) in zip(shapes, plan) if sl == 0]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=grid.device)
    outs = [torch.empty((b, *s), dtype=dtype, device=grid.device) if sl else None
            for s, (sl, _) in zip(shapes, plan)]
    if b * p > 0:
        lib = library()
        dims = (ctypes.c_int * (3 * len(shapes)))(*[d for s in shapes for d in s])
        plan_c = (ctypes.c_int * (2 * len(shapes)))(*[v for lv in plan for v in lv])
        out_ptrs = (ctypes.c_void_p * len(shapes))(*[o.data_ptr() if o is not None else None
                                                     for o in outs])
        with torch.cuda.device(grid.device):
            stream = torch.cuda.current_stream(grid.device).cuda_stream
            rc = lib.gather_lerp_bwd_launch(grid.data_ptr(), g.data_ptr(), b, p, len(shapes),
                                            dims, _DTYPES[g.dtype], plan_c, acc.data_ptr(),
                                            out_ptrs, _DTYPES[dtype], stream)
        if rc != 0:
            raise RuntimeError(f"gather_lerp_bwd kernel launch failed with CUDA error {rc}")
        launch_counts["gather_lerp_bwd"] += 1
    else:
        outs = [o.zero_() if o is not None else None for o in outs]
    fine = iter(torch.split(acc, sizes))
    return [o if o is not None else next(fine).view(b, *s).to(dtype)
            for o, s in zip(outs, shapes)]


class _GatherLerp(torch.autograd.Function):
    """gather_lerp with d/dfeat by :func:`gather_lerp_bwd`; the grid comes
    in detached and gets no gradient."""

    @staticmethod
    def forward(ctx, grid, *feats):
        ctx.save_for_backward(grid)
        ctx.shapes = [tuple(f.shape[1:]) for f in feats]
        ctx.dtype = feats[0].dtype
        return _gather_lerp_forward(grid, feats)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        dfeats = gather_lerp_bwd(grid, g.contiguous(), ctx.shapes, ctx.dtype)
        return (None, *[d if need else None
                        for d, need in zip(dfeats, ctx.needs_input_grad[1:])])


def gather_lerp(grid: torch.Tensor, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bilinear-sample up to five NHWC levels at ``grid`` [B,P,2] (f32) and
    channel-concatenate -> [B, P, sum C] in the maps' type (f32 or bf16).
    CPU tensors take :func:`gather_lerp_plain`.  Differentiable in the maps
    (backward :func:`gather_lerp_bwd`); the grid is detached."""
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        return _GatherLerp.apply(grid.detach(), *feats)
    return _gather_lerp_forward(grid, feats)


def _gather_lerp_forward(grid: torch.Tensor, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    if grid.device.type == "cpu":
        return gather_lerp_plain(grid, feats)
    if grid.device.type != "cuda":
        raise ValueError(f"gather_lerp: unsupported device {grid.device}")
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"gather_lerp: takes 1 to {MAX_LEVELS} levels, got {len(feats)}")
    b, p = _check_grid(grid, "gather_lerp")
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
