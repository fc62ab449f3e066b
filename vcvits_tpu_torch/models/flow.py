"""Residual-coupling normalizing flow (prior <-> posterior bridge), PyTorch.

Counterpart of vcvits_tpu/models/flow.py: mean-only couplings with a
zero-initialised `post`, and a channel flip between couplings. The forward
direction is the module path; the reverse (`kernel_reverse`, also
`forward(reverse=True)`) goes through ops/flow_coupling.py (kernel K2 on a
CUDA tensor, its plain version on a CPU tensor).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, FoldCache
from vcvits_tpu_torch.models.wavenet import WN
from vcvits_tpu_torch.ops.flow_coupling import Weights, coupling_reverse


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
        enc = self.enc
        hidden = enc.hidden_channels
        if enc.dilation_rate != 1:
            raise NotImplementedError("the coupling kernel takes dilation rate 1")
        w_in, b_in, w_rs, b_rs = [], [], [], []
        for i in range(enc.n_layers):
            conv = getattr(enc, f"in_{i}")
            w_in.append(conv.kernel().permute(2, 1, 0))  # [K, H, 2H]
            b_in.append(conv.bias)
            rs = getattr(enc, f"res_skip_{i}")
            kr, br = rs.kernel()[:, :, 0].t(), rs.bias      # [H, 2H | H]
            if kr.shape[1] == hidden:  # last layer: pack into the skip half
                kr = torch.cat([torch.zeros_like(kr), kr], dim=1)
                br = torch.cat([torch.zeros_like(br), br])
            w_rs.append(kr)
            b_rs.append(br)
        ws = (self.pre.kernel()[:, :, 0].t(), self.pre.bias, torch.stack(w_in),
              torch.stack(b_in), torch.stack(w_rs), torch.stack(b_rs),
              self.post.kernel()[:, :, 0].t(), self.post.bias)
        return tuple(w.detach().float().contiguous() for w in ws)


class ResidualCouplingBlock(FoldCache):
    """n_flows x (coupling + flip); forward z -> z_p, reverse iterates back
    through ops/flow_coupling.py on weights folded once (`FoldCache`)."""

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

    def kernel_reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                       g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inference reverse through ops/flow_coupling.py, one coupling
        per call; the flip and the speaker GEMV stay outside the kernel."""
        flows = [getattr(self, f"flow_{i}") for i in range(self.n_flows)]
        weights = self.folded(lambda: [flow.kernel_weights() for flow in flows])
        for flow, w in zip(reversed(flows), reversed(weights)):
            x = torch.flip(x, dims=[-1]).contiguous()
            x = coupling_reverse(x, x_mask, flow.enc.cond_vector(g), w)
        return x
