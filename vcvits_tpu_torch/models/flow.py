"""Residual-coupling normalizing flow (prior <-> posterior bridge), PyTorch.

Counterpart of vcvits_tpu/models/flow.py: mean-only couplings with a
zero-initialised `post`, and a channel flip between couplings. `forward`
is the module path in the forward direction (training: its WN gate is
kernel K5). The no-grad paths go through ops/flow_coupling.py, kernel K2
on a CUDA tensor and its plain version on a CPU tensor, one launch a
coupling: `kernel_reverse` (also `forward(reverse=True)`) and
`kernel_forward` (the flow forward of `voice_conversion`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, FoldCache
from vcvits_tpu_torch.models.wavenet import WN
from vcvits_tpu_torch.ops.flow_coupling import Weights, coupling_forward, coupling_reverse


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1, dtype=dtype)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, dtype=dtype)
        self.post = Conv1d(hidden_channels, self.half, 1, kernel_init="zeros", dtype=dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None):
        """The forward direction; the reverse is ops/flow_coupling.py."""
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (m + x1) * x_mask
        return torch.cat([x0, x1], dim=-1), torch.zeros(x.shape[0], device=x.device)

    def kernel_weights(self) -> Weights:
        """Folded float32 weights in ops/flow_coupling.py's layout."""
        w_in, b_in, w_rs, b_rs = self.enc.kernel_weights()
        ws = (self.pre.kernel()[:, :, 0].t(), self.pre.bias, w_in, b_in, w_rs, b_rs,
              self.post.kernel()[:, :, 0].t(), self.post.bias)
        return tuple(w.detach().float().contiguous() for w in ws)


class ResidualCouplingBlock(FoldCache):
    """n_flows x (coupling + flip); forward z -> z_p, reverse iterates back.
    The no-grad directions run ops/flow_coupling.py on weights folded once
    (`FoldCache`)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4, gin_channels: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"flow_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels, dtype=dtype))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                reverse: bool = False) -> torch.Tensor:
        if reverse:
            return self.kernel_reverse(x, x_mask, g)
        for i in range(self.n_flows):
            x, _ = getattr(self, f"flow_{i}")(x, x_mask, g=g)
            x = torch.flip(x, dims=[-1])
        return x

    def _kernel_weights(self):
        """The couplings and, folded once, each one's kernel weights and
        speaker layer."""
        flows = [getattr(self, f"flow_{i}") for i in range(self.n_flows)]
        return flows, self.folded(lambda: [(flow.kernel_weights(), flow.enc.cond_weights())
                                           for flow in flows])

    def kernel_forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                       g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`forward` without gradients through ops/flow_coupling.py, one
        coupling per call; the flip and the speaker GEMV stay outside the
        kernel."""
        flows, weights = self._kernel_weights()
        for flow, (w, cw) in zip(flows, weights):
            x = coupling_forward(x.contiguous(), x_mask, flow.enc.cond_vector(g, cw), w)
            x = torch.flip(x, dims=[-1])
        return x

    def kernel_reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                       g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inference reverse through ops/flow_coupling.py, one coupling
        per call; the flip and the speaker GEMV stay outside the kernel."""
        flows, weights = self._kernel_weights()
        for flow, (w, cw) in zip(reversed(flows), reversed(weights)):
            x = torch.flip(x, dims=[-1]).contiguous()
            x = coupling_reverse(x, x_mask, flow.enc.cond_vector(g, cw), w)
        return x
