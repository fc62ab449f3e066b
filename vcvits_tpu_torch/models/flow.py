"""Residual-coupling normalizing flow (prior <-> posterior bridge), PyTorch.

Counterpart of vcvits_tpu/models/flow.py: mean-only couplings with a
zero-initialised `post`, and a channel flip between couplings. `forward`
is the module path in the forward direction (training: its WN gate is
kernel K5). The no-grad paths go through ops/flow_coupling.py, kernel K2
on a CUDA tensor and its plain version on a CPU tensor, one launch a
coupling: `kernel_reverse` (also `forward(reverse=True)`) and
`kernel_forward` (the flow forward of `voice_conversion`).

The stochastic duration predictor's flows (models/predictors.py) are here
too: `Log`, `ElementwiseAffine`, `DDSConv` (the dilated depth-separable
conv stack, exact GELU) and `ConvFlow` (the spline coupling of
models/transforms.py, its `proj` zero-initialised). They compute in
float32 whatever the model's dtype, as the JAX package builds them (no
dtype passed), and run as plain PyTorch: their widths are 2 and the text
encoder's hidden width (128 in configs/48k_base.json).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, FoldCache, LayerNorm, dropout
from vcvits_tpu_torch.models.transforms import piecewise_rational_quadratic_transform
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


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """The Flip flow: reverse the channel (last) axis."""
    return torch.flip(x, dims=[-1])


class Log(nn.Module):
    """y = log(max(x, 1e-5)) * mask, log|det| = -sum(y); reverse exp(x) * mask."""

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
        if not reverse:
            y = torch.log(torch.clamp_min(x, 1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class ElementwiseAffine(nn.Module):
    """Per-channel affine flow y = (m + exp(logs) * x) * mask, parameters
    `m` and `logs` [channels], both zero at init."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.m.zero_()
            self.logs.zero_()

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs[None, None, :] * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack: per layer i (dilation k^i) a
    depthwise conv, LayerNorm, exact GELU, a 1x1 conv, LayerNorm, GELU,
    dropout, and a residual add; the output masked."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        for i in range(n_layers):
            self.add_module(f"sep_{i}", Conv1d(channels, channels, kernel_size,
                                               dilation=kernel_size ** i, groups=channels,
                                               dtype=dtype))
            self.add_module(f"norm1_{i}", LayerNorm(channels, dtype=dtype))
            self.add_module(f"pw_{i}", Conv1d(channels, channels, 1, dtype=dtype))
            self.add_module(f"norm2_{i}", LayerNorm(channels, dtype=dtype))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = getattr(self, f"sep_{i}")(x * x_mask)
            y = F.gelu(getattr(self, f"norm1_{i}")(y))
            y = getattr(self, f"pw_{i}")(y)
            y = F.gelu(getattr(self, f"norm2_{i}")(y))
            x = x + dropout(y, self.p_dropout, deterministic, generator)
        return x * x_mask


class ConvFlow(nn.Module):
    """Spline coupling over 2 channels: x0 -> 1x1 `pre` -> DDSConv (with
    the conditioning g added) -> zero-initialised 1x1 `proj` to the spline's
    K widths, K heights and K-1 inner derivatives per x1 channel, the
    widths and heights scaled by 1/sqrt(filter_channels); x1 goes through
    the linear-tailed spline (its inverse with `reverse`)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1,
                           kernel_init="zeros")

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, t, _ = x0.shape
        h = h.reshape(b, t, self.half, -1)
        k = self.num_bins
        # float32 on the host: a scalar copied to the card would wait for it
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.filter_channels)))
        x1_new, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :k] * scale, h[..., k:2 * k] * scale, h[..., 2 * k:], inverse=reverse,
            tails="linear", tail_bound=self.tail_bound)
        x_out = torch.cat([x0, x1_new], dim=-1) * x_mask
        if not reverse:
            return x_out, torch.sum(logabsdet * x_mask, dim=(1, 2))
        return x_out
