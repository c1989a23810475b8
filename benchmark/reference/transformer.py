"""DETR-style point-token transformer (``hoisdf_tpu/models/transformer.py``).

Post-norm layers, batch-first [B, T, C], packed-qkv attention that returns
head-averaged weights, per-layer normed encoder intermediates, and decoder
intermediates whose last entry is the final-norm output.  Masks are boolean
(True = disallowed) and fill with the finite ``NEG_INF``, so a fully masked
row gives uniform weights rather than NaN.  Dropout (rate ``dropout``, train
mode only) sits where the JAX package's does: on the attention weights, after
each attention block, inside the feed-forward after the ReLU and after it; its
masks come from the ``generator`` the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Dropout, LayerNorm, Linear, rounded

NEG_INF = -1e9


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``-compatible keys (in_proj_weight [3C, C],
    in_proj_bias, out_proj), written out so the weights come back."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        self.dropout = Dropout(dropout)

    round_operands = None

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c, nh = self.d_model, self.nhead
        hd = c // nh
        w = self.in_proj_weight.to(query.dtype)
        b = self.in_proj_bias.to(query.dtype)
        query, w = rounded(self, query, w)
        key, value = rounded(self, key, value)
        q = F.linear(query, w[:c], b[:c])
        k = F.linear(key, w[c:2 * c], b[c:2 * c])
        v = F.linear(value, w[2 * c:], b[2 * c:])
        bsz, tgt, _ = q.shape
        src = k.shape[1]
        q = q.reshape(bsz, tgt, nh, hd).transpose(1, 2)
        k = k.reshape(bsz, src, nh, hd).transpose(1, 2)
        v = v.reshape(bsz, src, nh, hd).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, NEG_INF)
        weights = self.dropout(torch.softmax(logits, dim=-1), generator)
        out = (weights @ v).transpose(1, 2).reshape(bsz, tgt, c)
        return self.out_proj(out), weights.mean(dim=1)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, src, pos, src_mask=None, generator=None):
        qk = src + pos
        sa = self.self_attn(qk, qk, src, src_mask, generator)[0]
        src = self.norm1(src + self.dropout(sa, generator))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(src)), generator))
        return self.norm2(src + self.dropout(ff, generator))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt, memory, pos, query_pos, tgt_mask=None, memory_mask=None,
                generator=None):
        qk = tgt + query_pos
        sa = self.self_attn(qk, qk, tgt, tgt_mask, generator)[0]
        tgt = self.norm1(tgt + self.dropout(sa, generator))
        ca, attn_wts = self.multihead_attn(tgt + query_pos, memory + pos, memory,
                                           memory_mask, generator)
        tgt = self.norm2(tgt + self.dropout(ca, generator))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(tgt)), generator))
        return self.norm3(tgt + self.dropout(ff, generator)), attn_wts


class Encoder(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, num_layers, dropout=0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_layers))
        self.inter_norm = LayerNorm(d_model)

    def forward(self, src, pos, src_mask=None, generator=None):
        out, inter = src, []
        for layer in self.layers:
            out = layer(out, pos, src_mask, generator)
            inter.append(self.inter_norm(out))
        return out, torch.stack(inter)  # [L, B, S, C]


class Decoder(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, num_layers, dropout=0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_layers))
        self.norm = LayerNorm(d_model)

    def forward(self, tgt, memory, pos, query_pos, tgt_mask=None, memory_mask=None,
                generator=None):
        out, inter, attn_all = tgt, [], []
        for layer in self.layers:
            out, attn = layer(out, memory, pos, query_pos, tgt_mask, memory_mask, generator)
            inter.append(self.norm(out))
            attn_all.append(attn)
        return torch.stack(inter), torch.stack(attn_all)  # [L,B,Q,C], [L,B,Q,S]


class Transformer(nn.Module):
    """Hand transformer: encoder over the point tokens, decoder over the
    MANO queries."""

    def __init__(self, d_model=256, nhead=4, num_encoder_layers=6,
                 num_decoder_layers=4, dim_feedforward=1024, dropout=0.0):
        super().__init__()
        self.encoder = Encoder(d_model, nhead, dim_feedforward, num_encoder_layers, dropout)
        self.decoder = Decoder(d_model, nhead, dim_feedforward, num_decoder_layers, dropout)

    def forward(self, src, pos, query_embed, tgt_mask=None, memory_mask=None,
                src_mask=None, generator=None):
        memory, enc_inter = self.encoder(src + pos, pos, src_mask, generator)
        query = query_embed[None].expand(src.shape[0], -1, -1).to(src.dtype)
        hs, attn_wts = self.decoder(torch.zeros_like(query), memory, pos, query,
                                    tgt_mask, memory_mask, generator)
        return hs, memory, enc_inter, attn_wts


class VoteTransformer(nn.Module):
    """Object transformer: encoder only."""

    def __init__(self, d_model=256, nhead=4, num_encoder_layers=3, dim_feedforward=1024,
                 dropout=0.0):
        super().__init__()
        self.encoder = Encoder(d_model, nhead, dim_feedforward, num_encoder_layers, dropout)

    def forward(self, src, pos, src_mask=None, generator=None):
        return self.encoder(src + pos, pos, src_mask, generator)


def get_mano_tgt_mask(num_queries: int = 17, shape_idx: int = 16) -> torch.Tensor:
    """Decoder self-attention mask: query 0 sees itself, each finger's three
    queries see their finger, the shape query sees itself."""
    mask = np.zeros((num_queries, num_queries), dtype=bool)
    mask[0, :] = True
    mask[0, 0] = False
    for i in range(5):
        s, e = 3 * i + 1, 3 * i + 4
        mask[s:e, :] = True
        mask[s:e, s:e] = False
    mask[shape_idx, :] = True
    mask[shape_idx, shape_idx] = False
    return torch.from_numpy(mask)


def get_mano_memory_mask(num_queries: int = 17, num_hand: int = 600,
                         num_obj: int = 200) -> torch.Tensor:
    """Cross-attention mask hiding the object tokens from the MANO queries."""
    mask = np.zeros((num_queries, num_hand + num_obj), dtype=bool)
    mask[:, num_hand:] = True
    return torch.from_numpy(mask)


def get_manoshape_memory_mask(num_hand: int = 600, num_obj: int = 200) -> torch.Tensor:
    """Single-query variant for the shape-only head."""
    return get_mano_memory_mask(1, num_hand, num_obj)
