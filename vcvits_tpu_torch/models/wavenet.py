"""Non-causal WaveNet stack (gated dilated convs, global conditioning).

Counterpart of vcvits_tpu/models/wavenet.py: n_layers of [dilated conv ->
gate with the speaker conditioning -> 1x1 res/skip], all weight-normed. The
last layer's res_skip has H outputs (skip only), not 2H. The gate goes
through ops/fused_gate.py (kernel K5 on a CUDA tensor, with its backward).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d
from vcvits_tpu_torch.ops.fused_gate import fused_gate


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, dtype=torch.float32):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.kernel_size = kernel_size
        self.dilation_rate = dilation_rate
        self.n_layers = n_layers
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1, weight_norm=True,
                                     dtype=dtype)
        else:
            self.cond_layer = None
        for i in range(n_layers):
            self.add_module(f"in_{i}", Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i,
                                              weight_norm=True, dtype=dtype))
            out = 2 * h if i < n_layers - 1 else h
            self.add_module(f"res_skip_{i}", Conv1d(h, out, 1, weight_norm=True, dtype=dtype))

    def cond_vector(self, g: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """[B, gin] speaker vector -> [B, n_layers * 2H] conditioning (fp32),
        or None without a speaker."""
        if g is None or self.cond_layer is None:
            return None
        c = self.cond_layer
        return g.float() @ c.kernel()[:, :, 0].t() + c.bias

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, T, H]; x_mask: [B, T, 1]; g: [B, gin]."""
        h = self.hidden_channels
        output = torch.zeros_like(x)
        cond = self.cond_layer(g[:, None, :]) if g is not None and self.cond_layer is not None \
            else None
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_{i}")(x)
            g_l = cond[:, :, i * 2 * h:(i + 1) * 2 * h] if cond is not None else None
            acts = fused_gate(x_in, g_l, h)
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask
