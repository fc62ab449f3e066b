"""Relative-position transformer encoder (the VITS prior encoder), PyTorch.

Counterpart of vcvits_tpu/models/attention.py: multi-head attention with
learned relative K/V embeddings (window 4, shared across heads, in the
encoders), the pad/reshape rel<->abs index shift, a -1e4 mask fill, the
conv FFN, the post-LN `TransformerEncoder`, and the causal
`TransformerDecoder` that no path of the JAX package builds. Dropout sits
where the JAX package has it (on the attention weights, after the FFN's
activation, on each sublayer's output) and acts only with
deterministic=False, drawing from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, dropout
from vcvits_tpu_torch.utils.masking import subsequent_mask


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
    """Multi-head attention with learned relative K/V position embeddings.

    The prior and text encoders' call, `attn(x, mask)`, is self-attention
    with a window of 4 shared across heads. JAX's other options: keys and
    values from a separate `c` [B, T_c, C] (cross-attention; the window
    needs T_c == T), `window_size=None` (no relative embeddings),
    `heads_share=False` (an embedding per head) and `proximal_bias` (a
    -log(1 + |q - k|) logit bias)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0, dtype=torch.float32,
                 heads_share: bool = True, proximal_bias: bool = False):
        super().__init__()
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.window_size = window_size
        self.proximal_bias = proximal_bias
        self.k_channels = channels // n_heads
        for name in ("conv_q", "conv_k", "conv_v"):
            self.add_module(name, Linear(channels, channels, kernel_init="xavier_uniform",
                                         dtype=dtype))
        self.conv_o = Linear(channels, out_channels, dtype=dtype)
        if window_size is not None:
            shape = (1 if heads_share else n_heads, 2 * window_size + 1, self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.empty(shape))
            self.emb_rel_v = nn.Parameter(torch.empty(shape))
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.window_size is None:
            return
        std = self.k_channels ** -0.5
        with torch.no_grad():
            for p in (self.emb_rel_k, self.emb_rel_v):
                p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * std)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor],
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (queries) [B, T, C]; c (keys and values) [B, T_c, C], x when
        None; attn_mask [B, 1, T, T_c] (1 attends) or None."""
        c = x if c is None else c
        b, t, _ = x.shape
        t_s = c.shape[1]
        h, d = self.n_heads, self.k_channels

        def heads(y, length):
            return y.reshape(b, length, h, d).transpose(1, 2)

        q = heads(self.conv_q(x), t) * (1.0 / math.sqrt(d))
        k, v = heads(self.conv_k(c), t_s), heads(self.conv_v(c), t_s)
        scores = torch.matmul(q, k.transpose(-1, -2))
        if self.window_size is not None:
            if t_s != t:
                raise ValueError("relative attention requires self-attention (T_c == T)")
            key_rel = _slice_relative_embeddings(self.emb_rel_k.to(self.dtype), t,
                                                 self.window_size)
            scores = scores + _rel_to_abs(torch.matmul(q, key_rel.transpose(-1, -2)))
        if self.proximal_bias:
            r = torch.arange(t_s, dtype=torch.float32, device=x.device)
            scores = scores + (-torch.log1p(torch.abs(r[None, :] - r[:, None]))).to(scores.dtype)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout, deterministic, generator)
        out = torch.matmul(p_attn, v)
        if self.window_size is not None:
            value_rel = _slice_relative_embeddings(self.emb_rel_v.to(self.dtype), t,
                                                   self.window_size)
            out = out + torch.matmul(_abs_to_rel(p_attn), value_rel)
        return self.conv_o(out.transpose(1, 2).reshape(b, t, h * d))


class ConvFFN(nn.Module):
    """Conv feed-forward block: conv -> relu (or the sigmoid-approximated
    gelu, x * sigmoid(1.702 x)) -> conv, masked; `causal` pads k - 1 frames
    on the left only."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0, dtype=torch.float32,
                 activation: Optional[str] = None, causal: bool = False):
        super().__init__()
        self.p_dropout = p_dropout
        self.activation = activation
        if kernel_size == 1:
            pad = (0, 0)
        elif causal:
            pad = (kernel_size - 1, 0)
        else:
            pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, padding=pad, dtype=dtype)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pad, dtype=dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv_1(x * x_mask)
        x = x * torch.sigmoid(1.702 * x) if self.activation == "gelu" else torch.relu(x)
        x = dropout(x, self.p_dropout, deterministic, generator)
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


class TransformerDecoder(nn.Module):
    """Causal decoder stack (JAX's TransformerDecoder): per layer, masked
    self-attention (no relative window, with the proximal bias by default),
    LayerNorm, cross-attention on the encoder output h, LayerNorm, a causal
    conv FFN, LayerNorm, each sublayer's output dropped out and added to its
    input. The self-attention mask is causal and within both lengths.
    x [B, T_x, C], h [B, T_h, C], masks [B, T, 1]."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 proximal_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        for i in range(n_layers):
            self.add_module(f"self_attn_{i}", RelativeMultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, None, p_dropout, dtype=dtype,
                proximal_bias=proximal_bias))
            self.add_module(f"norm0_{i}", LayerNorm(hidden_channels, dtype=dtype))
            self.add_module(f"encdec_attn_{i}", RelativeMultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, None, p_dropout, dtype=dtype))
            self.add_module(f"norm1_{i}", LayerNorm(hidden_channels, dtype=dtype))
            self.add_module(f"ffn_{i}", ConvFFN(
                hidden_channels, hidden_channels, filter_channels, kernel_size, p_dropout,
                dtype=dtype, causal=True))
            self.add_module(f"norm2_{i}", LayerNorm(hidden_channels, dtype=dtype))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, h: torch.Tensor,
                h_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mx, mh = x_mask[..., 0], h_mask[..., 0]
        self_mask = subsequent_mask(x.shape[1]).to(x.device) * (
            mx[:, None, :, None] * mx[:, None, None, :])
        encdec_mask = mx[:, None, :, None] * mh[:, None, None, :]
        x = x * x_mask
        p = self.p_dropout
        for i in range(self.n_layers):
            y = getattr(self, f"self_attn_{i}")(x, self_mask, deterministic, generator)
            x = getattr(self, f"norm0_{i}")(x + dropout(y, p, deterministic, generator))
            y = getattr(self, f"encdec_attn_{i}")(x, encdec_mask, deterministic, generator, c=h)
            x = getattr(self, f"norm1_{i}")(x + dropout(y, p, deterministic, generator))
            y = getattr(self, f"ffn_{i}")(x, x_mask, deterministic, generator)
            x = getattr(self, f"norm2_{i}")(x + dropout(y, p, deterministic, generator))
        return x * x_mask
