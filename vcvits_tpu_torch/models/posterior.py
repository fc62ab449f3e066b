"""WaveNet posterior encoder q(z | y_spec, g).

Counterpart of vcvits_tpu/models/posterior.py: 1x1 `pre` conv -> 16-layer
WN with the speaker conditioning -> 1x1 `proj` -> (m, logs), and the sample
z = (m + eps * exp(logs)) * mask. The WN runs as modules (its gate kernel
K5 on a CUDA tensor, with a backward), or with `fused_wn=True`, for no-grad
callers, as `WN.kernel_forward` (kernel K2's WaveNet mode, four layers a
launch).
`eps` replaces the normal draw from `generator` (tests inject JAX's draw).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d
from vcvits_tpu_torch.models.wavenet import WN
from vcvits_tpu_torch.utils.masking import sequence_mask


class PosteriorEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1, dtype=dtype)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, dtype=dtype)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, g: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                fused_wn: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: [B, T, spec_channels]; returns (z, m, logs, x_mask)."""
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(x.dtype)
        h = self.pre(x) * x_mask
        h = self.enc.kernel_forward(h, x_mask, g) if fused_wn else self.enc(h, x_mask, g=g)
        stats = self.proj(h) * x_mask
        m, logs = stats[..., :self.out_channels], stats[..., self.out_channels:]
        if eps is None:
            eps = torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
        z = (m + eps.to(m.device, m.dtype) * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask
