"""Text encoder of the TTS path (the prior p(z | text)), PyTorch.

Counterpart of vcvits_tpu/models/text_encoder.py: symbol embedding (ids
clipped into the vocabulary) x sqrt(hidden), the relative-position
`TransformerEncoder` of models/attention.py, and a 1x1 `proj` to
(m, logs). [B, T] ids in, (h, m, logs, x_mask) out, all [B, T, *].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from vcvits_tpu_torch.models.attention import TransformerEncoder
from vcvits_tpu_torch.models.layers import Conv1d, Embedding
from vcvits_tpu_torch.utils.masking import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
                 p_dropout: float, dtype=torch.float32):
        super().__init__()
        self.n_vocab = n_vocab
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = Embedding(n_vocab, hidden_channels, std=hidden_channels ** -0.5, dtype=dtype)
        self.encoder = TransformerEncoder(hidden_channels, filter_channels, n_heads, n_layers,
                                          kernel_size, p_dropout, dtype=dtype)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: [B, T] symbol ids; dropout (deterministic=False) draws from
        `generator`."""
        h = self.emb(torch.clamp(x, 0, self.n_vocab - 1)) * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(h.dtype)
        h = self.encoder(h * x_mask, x_mask, deterministic, generator)
        stats = self.proj(h) * x_mask
        return h, stats[..., :self.out_channels], stats[..., self.out_channels:], x_mask
