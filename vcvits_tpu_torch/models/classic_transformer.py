"""Classic (absolute-position) transformer encoder, PyTorch.

Counterpart of vcvits_tpu/models/classic_transformer.py, which no path of
the JAX package builds: post-LN layers as torch's
`nn.TransformerEncoderLayer` computes them (self-attention, dropout,
residual, LayerNorm, then Linear / ReLU / Linear, dropout, residual,
LayerNorm), every dense layer xavier-uniform initialised, a -1e4 mask
fill, [B, T, C] layout. `ClassicTransformerEncoder(..., output_layer=N)`
returns the hidden state after the first N layers. It carries no position
signal: pair it with utils/masking.py's `add_timing_signal_1d`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vcvits_tpu_torch.models.layers import LayerNorm, Linear, dropout


class ClassicEncoderLayer(nn.Module):
    """One post-LN encoder block (JAX's ClassicEncoderLayer)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 p_dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.p_dropout = p_dropout

        def dense(n_in, n_out):
            return Linear(n_in, n_out, kernel_init="xavier_uniform", dtype=dtype)

        for name in ("q", "k", "v", "out"):
            self.add_module(name, dense(hidden_channels, hidden_channels))
        self.norm1 = LayerNorm(hidden_channels, dtype=dtype)
        self.ffn1 = dense(hidden_channels, filter_channels)
        self.ffn2 = dense(filter_channels, hidden_channels)
        self.norm2 = LayerNorm(hidden_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C]; attn_mask [B, 1, T, T] (1 attends) or None."""
        b, t, c = x.shape
        h = self.n_heads
        d = c // h

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)

        p = self.p_dropout
        scores = torch.matmul(heads(self.q(x)) * (1.0 / math.sqrt(d)),
                              heads(self.k(x)).transpose(-1, -2))
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = dropout(torch.softmax(scores, dim=-1), p, deterministic, generator)
        y = torch.matmul(p_attn, heads(self.v(x))).transpose(1, 2).reshape(b, t, c)
        x = self.norm1(x + dropout(self.out(y), p, deterministic, generator))
        y = dropout(torch.relu(self.ffn1(x)), p, deterministic, generator)
        return self.norm2(x + dropout(self.ffn2(y), p, deterministic, generator))


class ClassicTransformerEncoder(nn.Module):
    """A stack of `ClassicEncoderLayer`s (`layer_{i}`) with the output_layer
    probe."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, p_dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", ClassicEncoderLayer(
                hidden_channels, filter_channels, n_heads, p_dropout, dtype=dtype))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                output_layer: Optional[int] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C]; x_mask [B, T, 1] or None; stop after `output_layer`
        layers (all of them when None)."""
        attn_mask = None
        if x_mask is not None:
            m = x_mask[..., 0]
            attn_mask = m[:, None, :, None] * m[:, None, None, :]
        n = self.n_layers if output_layer is None else min(output_layer, self.n_layers)
        for i in range(n):
            x = getattr(self, f"layer_{i}")(x, attn_mask, deterministic, generator)
        return x
