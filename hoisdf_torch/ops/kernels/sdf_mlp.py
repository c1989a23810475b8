"""Fused eval-mode SDF MLP: the CUDA kernel ``csrc/sdf_mlp.cu`` and its plain
PyTorch version.

Counterpart of ``hoisdf_tpu/ops/pallas/sdf_mlp.py``.  Used only inside the
field-guided sampler (no backward, dropout off).  Weight-norm folding and the
kernel's weight layout are made outside the kernel, once per forward
(:func:`fold_weight_norm`, then :func:`prepare_weights`).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from hoisdf_torch.ops.device_cache import device_cache
from hoisdf_torch.ops.kernels import launch_counts
from hoisdf_torch.ops.kernels.build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_weight_norm(decoder: torch.nn.Module) -> Tuple[torch.Tensor, ...]:
    """SDFDecoder weights as plain ``(w [in, out], b)`` pairs, f32:
    ``g * v / max(||v||, 1e-12)`` for the weight-normed layers 0-3."""
    ws = []
    for i in range(4):
        lin = getattr(decoder, f"linh{i}")
        ws.extend([lin.folded_weight().t().contiguous(), lin.bias])
    ws.extend([decoder.linh4.weight.t().contiguous(), decoder.linh4.bias])
    return tuple(w.detach() for w in ws)


def sdf_mlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: products and bias adds in
    f32, activations recast to x's type between layers, tanh -> [N, 1] f32."""
    dt = x.dtype
    w0, b0, w1, b1, w2, b2, w3, b3, w4, b4 = [w.to(dt).float() for w in weights]

    def layer(h, w, b):
        return torch.relu(h.float() @ w + b).to(dt)

    h = layer(x, w0, b0)
    h = layer(h, w1, b1)
    h = layer(torch.cat([h, x], dim=-1), w2, b2)
    h = layer(h, w3, b3)
    return torch.tanh(h.float() @ w4 + b4)


# The bf16 kernel's tiling (csrc/sdf_mlp.cu): a weight stage is STAGE_N
# output columns x PANEL_K input rows of W^T, K-major in 128-byte rows; a pass
# holds up to PASS_HALVES stages' columns in its accumulators.
STAGE_N = 128
PANEL_K = 64
PASS_HALVES = 2


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle on rows of 64 bf16 (``t[..., rows, 64]``): the
    16-byte chunk ``c`` of row ``r`` moves to chunk ``c ^ (r % 8)``.  Its own
    inverse."""
    rows = t.shape[-2]
    v = t.reshape(*t.shape[:-1], 8, 8)
    r = torch.arange(rows, device=t.device)[:, None] % 8
    src = torch.arange(8, device=t.device)[None, :] ^ r  # [rows, 8]
    return torch.gather(v, -2, src[:, :, None].expand_as(v)).reshape(t.shape)


def _layer_ranges(in_dim: int, h: Sequence[int]):
    """(width, k-ranges) of the four hidden layers; layer 2 takes [h1 | x]."""
    return ((h[0], (in_dim,)), (h[1], (h[0],)), (h[2], (h[1], in_dim)), (h[3], (h[2],)))


@device_cache(maxsize=8)
def _stage_index(in_dim: int, h: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Where each element of the run of weight stages comes from in the four
    zero-padded W^T laid end to end (one gather then packs a forward's
    weights).  Per layer, W^T ``[halves * 128, sum of round64(k)]`` is cut into
    tiles of 128 columns x 64 k.  The stages follow the consumer's walk: layer
    by layer; per pass of two column halves; per k panel; the pass's halves
    in turn.  Every tile is stored K-major in the 128-byte swizzle, so a bulk
    copy lands it as a wgmma B operand."""
    stages, base = [], 0
    for n, ks in _layer_ranges(in_dim, h):
        halves, panels = -(-n // STAGE_N), sum(-(-k // PANEL_K) for k in ks)
        size = halves * STAGE_N * panels * PANEL_K
        tiles = torch.arange(base, base + size, device=device).reshape(
            halves, STAGE_N, panels, PANEL_K).permute(0, 2, 1, 3)
        for h0 in range(0, halves, PASS_HALVES):  # [halves in pass, k panels, 128, 64]
            stages.append(tiles[h0:h0 + PASS_HALVES].transpose(0, 1)
                          .reshape(-1, STAGE_N, PANEL_K))
        base += size
    return swizzle128(torch.cat(stages)).reshape(-1)


def _pack_bf16(w, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four hidden weights as the run of shared-memory stage images the
    kernel's producer copies, ``[n_stages, STAGE_N * PANEL_K]`` bf16
    (:func:`_stage_index`), and the vectors b0..b3 and w4, each zero-padded to
    a multiple of STAGE_N, in one run (a padded column then adds a zero bias
    and a zero output weight).  Each k-range of a layer starts at a multiple
    of PANEL_K in its W^T; rows past the layer's width and columns between
    ranges are zero."""
    in_dim, dev = w[0].shape[0], w[0].device
    padded = []
    for (n, ks), wl in zip(_layer_ranges(in_dim, h), (w[0], w[2], w[4], w[6])):
        wt = torch.zeros(_round(n, STAGE_N), sum(_round(k, PANEL_K) for k in ks),
                         dtype=torch.bfloat16, device=dev)
        row = off = 0
        for k in ks:
            wt[:n, off:off + k] = wl[row:row + k].t()
            row, off = row + k, off + _round(k, PANEL_K)
        padded.append(wt.reshape(-1))
    stages = torch.cat(padded)[_stage_index(in_dim, tuple(h), dev)]
    vectors = torch.zeros(sum(_round(n, STAGE_N) for n in (*h, h[3])),
                          dtype=torch.bfloat16, device=dev)
    off = 0
    for v in (w[1], w[3], w[5], w[7], w[8]):
        vectors[off:off + v.numel()] = v.reshape(-1)
        off += _round(v.numel(), STAGE_N)
    return stages.reshape(-1, STAGE_N * PANEL_K), vectors


# The f32 kernel's tiling: widths and k-ranges pad to a multiple of PAD_F32; a
# pass holds up to PASS_N output columns; each pass streams its weights as
# k-slices of SLICE_K rows x the pass's columns, row-major.
SLICE_K = 8
PAD_F32 = 8
PASS_N = 512


def f32_passes(n: int) -> List[Tuple[int, int]]:
    """(first column, width) of each pass of a layer n wide, padded to PAD_F32."""
    n_pad = _round(n, PAD_F32)
    return [(n0, min(PASS_N, n_pad - n0)) for n0 in range(0, n_pad, PASS_N)]


def _pack_f32(w, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four hidden weights as the run of k-slices the f32 kernel's producer
    copies (one flat f32 run: slices of SLICE_K rows x a pass's width, one
    width per pass), and the vectors b0..b3 and w4, each zero-padded to a
    multiple of PAD_F32.  Per layer, W ``[sum of padded k-ranges, padded
    width]`` holds each k-range's rows from a multiple of PAD_F32, zeros
    elsewhere; the slices follow the consumers' walk: layer, pass, k
    (:func:`f32_slice_count` counts them)."""
    in_dim, dev = w[0].shape[0], w[0].device
    runs = []
    for (n, ks), wl in zip(_layer_ranges(in_dim, h), (w[0], w[2], w[4], w[6])):
        wp = torch.zeros(sum(_round(k, PAD_F32) for k in ks), _round(n, PAD_F32),
                         dtype=torch.float32, device=dev)
        row = off = 0
        for k in ks:
            wp[off:off + k, :n] = wl[row:row + k]
            row, off = row + k, off + _round(k, PAD_F32)
        runs.extend(wp[:, n0:n0 + pw].reshape(-1) for n0, pw in f32_passes(n))
    vectors = torch.zeros(sum(_round(n, PAD_F32) for n in (*h, h[3])),
                          dtype=torch.float32, device=dev)
    off = 0
    for v in (w[1], w[3], w[5], w[7], w[8]):
        vectors[off:off + v.numel()] = v.reshape(-1)
        off += _round(v.numel(), PAD_F32)
    return torch.cat(runs), vectors


def f32_slice_count(in_dim: int, h: Sequence[int]) -> int:
    """How many k-slices :func:`_pack_f32` makes (the kernel checks it)."""
    return sum(len(f32_passes(n)) * sum(_round(k, PAD_F32) for k in ks) // SLICE_K
               for n, ks in _layer_ranges(in_dim, h))


class MlpWeights(NamedTuple):
    """The weights as :func:`sdf_mlp` takes them (:func:`prepare_weights`)."""

    plain: Tuple[torch.Tensor, ...]  # the ten of fold_weight_norm, in one dtype
    # the kernel's layout: bf16 weight stages or f32 k-slices (one flat run),
    # and the padded vectors
    packed: Tuple[torch.Tensor, torch.Tensor]

    @property
    def in_dim(self) -> int:
        return self.plain[0].shape[0]


def prepare_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype) -> MlpWeights:
    """Cast the ten tensors of :func:`fold_weight_norm` to ``dtype`` (f32 or
    bf16), check that their shapes chain, and pack the four hidden weights
    into the kernel's layout (:func:`_pack_bf16`, :func:`_pack_f32`)."""
    if dtype not in _DTYPES:
        raise TypeError(f"sdf_mlp: dtype {dtype} not in {list(_DTYPES)}")
    if len(weights) != 10:
        raise ValueError(f"sdf_mlp: expected 10 weight tensors, got {len(weights)}")
    w = tuple(t.to(dtype).contiguous() for t in weights)
    in_dim = w[0].shape[0]
    h = [w[0].shape[1], w[2].shape[1], w[4].shape[1], w[6].shape[1]]
    want = [(in_dim, h[0]), (h[0],), (h[0], h[1]), (h[1],), (h[1] + in_dim, h[2]),
            (h[2],), (h[2], h[3]), (h[3],), (h[3], 1), (1,)]
    got = [tuple(t.shape) for t in w]
    if got != want:
        raise ValueError(f"sdf_mlp: weight shapes {got} != expected {want}")
    if len({t.device for t in w}) != 1:
        raise ValueError("sdf_mlp: weights lie on more than one device")
    return MlpWeights(w, (_pack_bf16 if dtype == torch.bfloat16 else _pack_f32)(w, h))


def sdf_mlp(x: torch.Tensor, weights: MlpWeights) -> torch.Tensor:
    """Fused SDF decode ``[N, in] -> [N, 1]`` f32.

    ``weights`` come from :func:`prepare_weights` in x's type (f32 or bf16)
    and on x's device.  The custom op ``hoisdf_torch::sdf_mlp``: CPU tensors
    take :func:`sdf_mlp_plain`, CUDA tensors the kernel."""
    return torch.ops.hoisdf_torch.sdf_mlp(x, list(weights.plain), *weights.packed)


@torch.library.custom_op("hoisdf_torch::sdf_mlp", mutates_args=(), device_types="cpu")
def _sdf_mlp_op(x: torch.Tensor, weights: List[torch.Tensor], stages: torch.Tensor,
                vectors: torch.Tensor) -> torch.Tensor:
    return sdf_mlp_plain(x, weights)


@_sdf_mlp_op.register_fake
def _(x, weights, stages, vectors):
    return x.new_empty((x.shape[0], 1), dtype=torch.float32)


@_sdf_mlp_op.register_kernel("cuda")
def _(x, weights, stages, vectors):
    if x.dtype not in _DTYPES:
        raise TypeError(f"sdf_mlp: x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"sdf_mlp: x must be a contiguous [N, in] matrix, got {tuple(x.shape)}")
    w = list(weights)
    if w[0].dtype != x.dtype or w[0].device != x.device:
        raise ValueError(f"sdf_mlp: weights are {w[0].dtype} on {w[0].device}, "
                         f"x is {x.dtype} on {x.device}; prepare them for x")
    n, in_dim = x.shape
    if in_dim != w[0].shape[0]:
        raise ValueError(f"sdf_mlp: x has {in_dim} columns, the weights take {w[0].shape[0]}")
    h = [w[0].shape[1], w[2].shape[1], w[4].shape[1], w[6].shape[1]]
    out = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    w[0], w[1] = stages, vectors
    n_stages = stages.shape[0] if x.dtype == torch.bfloat16 else f32_slice_count(in_dim, h)
    lib = library()
    ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in w])
    dims = (ctypes.c_int * 4)(*h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sdf_mlp_launch(x.data_ptr(), _DTYPES[x.dtype], n, in_dim, ptrs,
                                dims, n_stages, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sdf_mlp kernel launch failed with CUDA error {rc}")
    launch_counts["sdf_mlp"] += 1
    return out
