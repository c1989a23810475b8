"""Fused eval-mode SDF MLP: the CUDA kernel ``csrc/sdf_mlp.cu`` and its plain
PyTorch version.

Counterpart of ``hoisdf_tpu/ops/pallas/sdf_mlp.py``.  Used only inside the
field-guided sampler (no backward, dropout off).  Weight-norm folding and the
kernel's weight layout are made outside the kernel, once per forward
(:func:`fold_weight_norm`, then :func:`prepare_weights`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

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


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def _pack_bf16(w, h):
    """The tensor-core layout of the four hidden weights: W^T zero-padded to
    [round128(out), sum of round32(k)], one k-range per input segment (layer
    2 takes the skip input as a second range)."""
    ranges = ([w[0]], [w[2]], [w[4][: h[1]], w[4][h[1]:]], [w[6]])
    packed = []
    for segs in ranges:
        n = segs[0].shape[1]
        out = torch.zeros(_round(n, 128), sum(_round(s.shape[0], 32) for s in segs),
                          dtype=torch.bfloat16, device=w[0].device)
        off = 0
        for s in segs:
            out[:n, off:off + s.shape[0]] = s.t()
            off += _round(s.shape[0], 32)
        packed.append(out)
    return tuple(packed)


class MlpWeights(NamedTuple):
    """The weights as :func:`sdf_mlp` takes them (:func:`prepare_weights`)."""

    plain: Tuple[torch.Tensor, ...]  # the ten of fold_weight_norm, in one dtype
    packed: Optional[Tuple[torch.Tensor, ...]]  # bf16: w0..w3 in the kernel's layout

    @property
    def in_dim(self) -> int:
        return self.plain[0].shape[0]


def prepare_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype) -> MlpWeights:
    """Cast the ten tensors of :func:`fold_weight_norm` to ``dtype`` (f32 or
    bf16), check that their shapes chain, and for bf16 pack the four hidden
    weights for the tensor cores (:func:`_pack_bf16`)."""
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
    return MlpWeights(w, _pack_bf16(w, h) if dtype == torch.bfloat16 else None)


def sdf_mlp(x: torch.Tensor, weights: MlpWeights) -> torch.Tensor:
    """Fused SDF decode ``[N, in] -> [N, 1]`` f32.

    ``weights`` come from :func:`prepare_weights` in x's type (f32 or bf16)
    and on x's device.  CPU tensors take :func:`sdf_mlp_plain`."""
    if x.device.type == "cpu":
        return sdf_mlp_plain(x, weights.plain)
    if x.device.type != "cuda":
        raise ValueError(f"sdf_mlp: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"sdf_mlp: x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"sdf_mlp: x must be a contiguous [N, in] matrix, got {tuple(x.shape)}")
    w = list(weights.plain)
    if w[0].dtype != x.dtype or w[0].device != x.device:
        raise ValueError(f"sdf_mlp: weights are {w[0].dtype} on {w[0].device}, "
                         f"x is {x.dtype} on {x.device}; prepare them for x")
    n, in_dim = x.shape
    if in_dim != weights.in_dim:
        raise ValueError(f"sdf_mlp: x has {in_dim} columns, the weights take {weights.in_dim}")
    h = [w[0].shape[1], w[2].shape[1], w[4].shape[1], w[6].shape[1]]
    out = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    if x.dtype == torch.bfloat16:
        w[0], w[2], w[4], w[6] = weights.packed
    lib = library()
    ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in w])
    dims = (ctypes.c_int * 4)(*h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sdf_mlp_launch(x.data_ptr(), _DTYPES[x.dtype], n, in_dim, ptrs,
                                dims, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sdf_mlp kernel launch failed with CUDA error {rc}")
    launch_counts["sdf_mlp"] += 1
    return out
