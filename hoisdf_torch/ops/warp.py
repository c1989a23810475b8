"""The affine image warp on the tensors' own device (``hoisdf_tpu/ops/warp.py``).

The datasets warp on the host (PIL's ``transform`` with NEAREST, or the
native pipeline); this is the same warp in plain torch ops, for a crop
stage that runs on the card.  It keeps the JAX function's conventions: the
affine maps source pixels to output pixels, output pixel centres ``(x + 0.5,
y + 0.5)`` go through its inverse, nearest takes the floor (bit-identical to
PIL's NEAREST), bilinear interpolates between pixel centres, and a sample
outside the image is 0.

The inverse and the source coordinates are f32 and take the JAX function's
steps on the CPU, rounding for rounding: the inverse is LAPACK's (an LU
factorisation with partial pivoting, scaled by the pivot's reciprocal, then
two triangular solves whose updates are fused multiply-adds), and each
coordinate is ``fma(a1, y, a0 * x) + a2``, XLA's order for the 3-term dot.
A fused multiply-add is taken exactly in f64 and rounded once to f32.  Every
step is an elementwise op, so the card rounds as the CPU does and nearest
picks the same pixel on both.  Nearest returns the image's dtype; bilinear
returns it for a floating image and f32 otherwise.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (the f64 product of two f32 is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _inverse3(m: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] f32 -> its inverse, by LAPACK's steps (getrf, then trsm on
    the permuted identity)."""
    b = m.shape[0]
    a = m.clone()
    x = torch.eye(3, dtype=m.dtype, device=m.device).expand(b, 3, 3).clone()
    rows = torch.arange(b, device=m.device)
    for j in range(3):
        # partial pivoting: swap row j with the first row of largest |a[:, j]|
        p = j + a[:, j:, j].abs().argmax(1)
        idx = torch.arange(3, device=m.device).repeat(b, 1)
        idx[rows, j] = p
        idx[rows, p] = j
        idx = idx[:, :, None].expand(-1, -1, 3)
        a, x = a.gather(1, idx), x.gather(1, idx)
        a[:, j + 1:, j] = a[:, j + 1:, j] * (1 / a[:, j, j, None])
        a[:, j + 1:, j + 1:] = a[:, j + 1:, j + 1:] - a[:, j + 1:, j, None] * a[:, j, None, j + 1:]
    for j in range(3):  # unit lower triangle, column by column
        for i in range(j + 1, 3):
            x[:, i] = _fma(-a[:, i, j, None], x[:, j], x[:, i])
    for j in range(2, -1, -1):  # upper triangle, by the pivots' reciprocals
        x[:, j] = x[:, j] * (1 / a[:, j, j, None])
        for i in range(j):
            x[:, i] = _fma(-a[:, i, j, None], x[:, j], x[:, i])
    return x


def affine_warp_image(img: torch.Tensor, affine: torch.Tensor, out_hw: Tuple[int, int],
                      mode: str = "nearest") -> torch.Tensor:
    """Warp ``img`` [B, H, W, C] so that ``out[dst] = img[affine^-1 @ dst]``
    for ``affine`` [B, 3, 3] (source pixels -> output pixels) into
    [B, oh, ow, C]; ``mode`` is ``"nearest"`` or ``"bilinear"``."""
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"mode {mode!r}")
    if img.dim() != 4 or affine.shape != (img.shape[0], 3, 3):
        raise ValueError(f"img {tuple(img.shape)} and affine {tuple(affine.shape)}: "
                         "expected [B, H, W, C] and [B, 3, 3]")
    b, h, w, c = img.shape
    oh, ow = out_hw
    inv = _inverse3(affine.to(device=img.device, dtype=torch.float32))
    ys = torch.arange(oh, device=img.device, dtype=torch.float32)
    xs = torch.arange(ow, device=img.device, dtype=torch.float32)
    yc = (ys[:, None] + 0.5).expand(oh, ow).reshape(1, -1)  # PIL samples at
    xc = (xs[None, :] + 0.5).expand(oh, ow).reshape(1, -1)  # output-pixel centres

    def coord(k: int) -> torch.Tensor:
        return _fma(inv[:, k, 1, None], yc, inv[:, k, 0, None] * xc) + inv[:, k, 2, None]

    z = coord(2)
    sx, sy = coord(0) / z, coord(1) / z  # [B, P]
    flat = img.reshape(b, h * w, c)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        yi = yi.clamp(0, h - 1).long()
        xi = xi.clamp(0, w - 1).long()
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1, c))

    if mode == "nearest":
        out = gather(torch.floor(sy), torch.floor(sx))
        valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        out = torch.where(valid[..., None], out, torch.zeros((), dtype=img.dtype,
                                                             device=img.device))
        return out.reshape(b, oh, ow, c)
    # bilinear interpolates in pixel-index space (centres at integers)
    sx, sy = sx - 0.5, sy - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    f00, f01 = gather(y0, x0).float(), gather(y0, x0 + 1).float()
    f10, f11 = gather(y0 + 1, x0).float(), gather(y0 + 1, x0 + 1).float()
    out = (f00 * (1 - wx) + f01 * wx) * (1 - wy) + (f10 * (1 - wx) + f11 * wx) * wy
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    out = out * valid[..., None].float()
    if img.dtype.is_floating_point:
        out = out.to(img.dtype)
    return out.reshape(b, oh, ow, c)
