"""NeRF-style sinusoidal positional encoding (``hoisdf_tpu/ops/nerf.py``)."""

from __future__ import annotations

import torch


def nerf_positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Encode points ``[..., D] -> [..., 2*num_freqs*D]``.

    Column layout follows the original Embedder loop order:
    ``[sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...]``, each block D wide,
    with log-sampled bands ``2**linspace(0, num_freqs-1, num_freqs)``.
    """
    freqs = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs, device=x.device)
    xf = x[..., None, :] * freqs.to(x.dtype)[:, None]  # [..., F, D]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, D]
    return enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
