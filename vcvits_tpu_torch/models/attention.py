"""Relative-position transformer encoder (the VITS prior encoder), PyTorch.

Counterpart of vcvits_tpu/models/attention.py: multi-head self-attention
with learned relative K/V embeddings (window 4, shared across heads), the
pad/reshape rel<->abs index shift, a -1e4 mask fill, the conv FFN and the
post-LN `TransformerEncoder`. Dropout sits where the JAX package has it
(on the attention weights, after the FFN's relu, on each sublayer's output)
and acts only with deterministic=False, drawing from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, dropout


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, length * 2 * length), (0, length - 1))
    x_final = x_flat.reshape(b, h, length + 1, 2 * length - 1)
    return x_final[:, :, :length, length - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] attention weights -> [B, H, L, 2L-1] relative."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1))
    x_flat = F.pad(x.reshape(b, h, length * length + length * (length - 1)), (length, 0))
    return x_flat.reshape(b, h, length, 2 * length)[:, :, :, 1:]


def _slice_relative_embeddings(emb: torch.Tensor, length: int, window_size: int) -> torch.Tensor:
    """[n_heads_rel, 2*ws+1, d] -> [n_heads_rel, 2L-1, d]."""
    pad_length = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start:start + 2 * length - 1]


class RelativeMultiHeadAttention(nn.Module):
    """Self-attention with learned relative K/V position embeddings shared
    across heads (the only configuration the conversion path uses)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, p_dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.window_size = window_size
        self.k_channels = channels // n_heads
        for name in ("conv_q", "conv_k", "conv_v"):
            self.add_module(name, Linear(channels, channels, kernel_init="xavier_uniform",
                                         dtype=dtype))
        self.conv_o = Linear(channels, out_channels, dtype=dtype)
        shape = (1, 2 * window_size + 1, self.k_channels)
        self.emb_rel_k = nn.Parameter(torch.empty(shape))
        self.emb_rel_v = nn.Parameter(torch.empty(shape))
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = self.k_channels ** -0.5
        with torch.no_grad():
            self.emb_rel_k.copy_(torch.randn(self.emb_rel_k.shape, generator=gen) * std)
            self.emb_rel_v.copy_(torch.randn(self.emb_rel_v.shape, generator=gen) * std)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C]; attn_mask: [B, 1, T, T]."""
        b, t, _ = x.shape
        h, d = self.n_heads, self.k_channels

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)

        q = heads(self.conv_q(x)) * (1.0 / math.sqrt(d))
        k, v = heads(self.conv_k(x)), heads(self.conv_v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        key_rel = _slice_relative_embeddings(self.emb_rel_k.to(self.dtype), t, self.window_size)
        scores = scores + _rel_to_abs(torch.matmul(q, key_rel.transpose(-1, -2)))
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout, deterministic, generator)
        out = torch.matmul(p_attn, v)
        value_rel = _slice_relative_embeddings(self.emb_rel_v.to(self.dtype), t, self.window_size)
        out = out + torch.matmul(_abs_to_rel(p_attn), value_rel)
        return self.conv_o(out.transpose(1, 2).reshape(b, t, h * d))


class ConvFFN(nn.Module):
    """Conv feed-forward block: conv -> relu -> conv, masked."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.p_dropout = p_dropout
        pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, padding=pad, dtype=dtype)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pad, dtype=dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(torch.relu(self.conv_1(x * x_mask)), self.p_dropout, deterministic,
                    generator)
        return self.conv_2(x * x_mask) * x_mask


class TransformerEncoder(nn.Module):
    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 window_size: int = 4, dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        for i in range(n_layers):
            self.add_module(f"attn_{i}", RelativeMultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, window_size, p_dropout, dtype=dtype))
            self.add_module(f"norm1_{i}", LayerNorm(hidden_channels, dtype=dtype))
            self.add_module(f"ffn_{i}", ConvFFN(
                hidden_channels, hidden_channels, filter_channels, kernel_size, p_dropout,
                dtype=dtype))
            self.add_module(f"norm2_{i}", LayerNorm(hidden_channels, dtype=dtype))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C]; x_mask: [B, T, 1]."""
        m = x_mask[..., 0]
        attn_mask = m[:, None, :, None] * m[:, None, None, :]
        x = x * x_mask
        p = self.p_dropout
        for i in range(self.n_layers):
            y = getattr(self, f"attn_{i}")(x, attn_mask, deterministic, generator)
            x = getattr(self, f"norm1_{i}")(x + dropout(y, p, deterministic, generator))
            y = getattr(self, f"ffn_{i}")(x, x_mask, deterministic, generator)
            x = getattr(self, f"norm2_{i}")(x + dropout(y, p, deterministic, generator))
        return x * x_mask
