"""Duration, pitch and energy predictors of the TTS path, PyTorch.

Counterpart of vcvits_tpu/models/predictors.py, with its quirks kept:

* `VariancePredictor` (pitch, energy): FastPitch's `ConvReLUNorm` layers
  (conv, relu, flax's nn.LayerNorm: eps 1e-6, params `scale` / `bias`,
  not the layers.LayerNorm of the rest of the model), a `fc` Dense, masked.
* `DurationPredictor`: the deterministic conv predictor on the detached
  text encoding (and speaker).
* `StochasticDurationPredictor`: the spline-flow NLL of the log-durations
  (training) and their sampler (inference). Its width is the input's
  (`filter_channels` is overridden by `in_channels`, as in the reference),
  its input and speaker are detached, it computes in float32 whatever the
  model's dtype (the JAX package builds it with no dtype), and the sampler
  skips the first of its flows (the reference's "useless vflow"), keeping
  the flip. Its normal draws are injectable (`noise`) or come from a
  generator; dropout (deterministic=False) draws from `dropout_generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vcvits_tpu_torch.models.flow import ConvFlow, DDSConv, ElementwiseAffine, Log, flip_channels
from vcvits_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, dropout

FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm's default


class ConvReLUNorm(nn.Module):
    """conv -> relu -> LayerNorm (flax's) -> dropout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.p_dropout = dropout
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           padding=(kernel_size // 2, kernel_size // 2), dtype=dtype)
        self.norm = LayerNorm(out_channels, eps=FLAX_LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.norm(torch.relu(self.conv(x)))
        return dropout(y, self.p_dropout, deterministic, generator)


class VariancePredictor(nn.Module):
    """FastPitch-style pitch / energy predictor: [B, T, C] -> [B, T, 1]."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 3,
                 dropout: float = 0.1, n_layers: int = 2, n_predictions: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", ConvReLUNorm(
                in_channels if i == 0 else filter_channels, filter_channels, kernel_size,
                dropout, dtype=dtype))
        self.fc = Linear(filter_channels, n_predictions, dtype=dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = x * x_mask
        for i in range(self.n_layers):
            out = getattr(self, f"layer_{i}")(out, deterministic, generator)
        return self.fc(out) * x_mask


def average_by_duration(values: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Mean of the non-zero frame values of each token: values [B, T_frames],
    durs [B, T_tokens] integer -> [B, T_tokens]."""
    t = values.shape[1]
    ends = torch.cumsum(durs, dim=1).to(torch.int64)
    starts = torch.nn.functional.pad(ends[:, :-1], (1, 0))
    nz_cum = torch.nn.functional.pad(torch.cumsum((values != 0).to(values.dtype), dim=1), (1, 0))
    val_cum = torch.nn.functional.pad(torch.cumsum(values, dim=1), (1, 0))

    def take(arr, idx):
        return torch.gather(arr, 1, torch.clamp(idx, 0, t))

    sums = take(val_cum, ends) - take(val_cum, starts)
    counts = take(nz_cum, ends) - take(nz_cum, starts)
    return torch.where(counts == 0, torch.zeros_like(sums), sums / torch.clamp_min(counts, 1.0))


class DurationPredictor(nn.Module):
    """Deterministic conv duration predictor: log-durations [B, T, 1]."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 3,
                 p_dropout: float = 0.5, gin_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.p_dropout = p_dropout
        self.cond = Linear(gin_channels, in_channels, dtype=dtype) if gin_channels > 0 else None
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, dtype=dtype)
        self.norm_1 = LayerNorm(filter_channels, dtype=dtype)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size, dtype=dtype)
        self.norm_2 = LayerNorm(filter_channels, dtype=dtype)
        self.proj = Conv1d(filter_channels, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())[:, None, :]
        p = self.p_dropout
        x = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        x = dropout(x, p, deterministic, generator)
        x = self.norm_2(torch.relu(self.conv_2(x * x_mask)))
        x = dropout(x, p, deterministic, generator)
        return self.proj(x * x_mask) * x_mask


class StochasticDurationPredictor(nn.Module):
    """Spline-flow model of the log-durations: `forward` gives each row's
    NLL of the durations w [B, T, 1] (training), `forward(reverse=True)`
    samples log-durations [B, T, 1] (inference)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 3,
                 p_dropout: float = 0.5, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        fc = in_channels  # the reference's quirk: filter_channels = in_channels
        self.n_flows = n_flows
        self.log_flow = Log()
        self.pre_affine = ElementwiseAffine(2)
        for i in range(n_flows):
            self.add_module(f"flow_{i}", ConvFlow(2, fc, kernel_size, n_layers=3))
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3)
        self.post_affine = ElementwiseAffine(2)
        for i in range(4):
            self.add_module(f"post_flow_{i}", ConvFlow(2, fc, kernel_size, n_layers=3))
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        self.cond = Conv1d(gin_channels, fc, 1) if gin_channels > 0 else None

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, w: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                noise_scale: float = 1.0, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, in] text encoding; x_mask [B, T, 1]. `noise` [B, T, 2]
        replaces the standard normal draw from `generator` (e_q in
        training, the sampler's z in inference). Float32 out."""
        x_mask = x_mask.float()
        x = self.pre(x.detach().float())
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach().float()[:, None, :])
        x = self.convs(x, x_mask, deterministic=deterministic, generator=dropout_generator)
        x = self.proj(x) * x_mask
        b, t, _ = x.shape
        if noise is None:
            noise = torch.randn(b, t, 2, generator=generator, device=x.device)
        noise = noise.to(x.device, torch.float32)

        if not reverse:
            if w is None:
                raise ValueError("the training direction needs the durations w")
            w = w.float()
            h_w = self.post_proj(self.post_convs(self.post_pre(w), x_mask)) * x_mask
            e_q = noise * x_mask
            z_q, logdet_tot_q = self.post_affine(e_q, x_mask)
            for i in range(4):
                z_q, ld = getattr(self, f"post_flow_{i}")(z_q, x_mask, g=x + h_w)
                logdet_tot_q = logdet_tot_q + ld
                z_q = flip_channels(z_q)
            z_u, z1 = z_q[..., :1], z_q[..., 1:]
            u = torch.sigmoid(z_u) * x_mask
            z0 = (w - u) * x_mask
            logsig = torch.nn.functional.logsigmoid
            logdet_tot_q = logdet_tot_q + torch.sum((logsig(z_u) + logsig(-z_u)) * x_mask,
                                                    dim=(1, 2))
            logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask, dim=(1, 2)) \
                - logdet_tot_q

            z0, logdet_tot = self.log_flow(z0, x_mask)
            z, ld = self.pre_affine(torch.cat([z0, z1], dim=-1), x_mask)
            logdet_tot = logdet_tot + ld
            for i in range(self.n_flows):
                z, ld = getattr(self, f"flow_{i}")(z, x_mask, g=x)
                logdet_tot = logdet_tot + ld
                z = flip_channels(z)
            nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask, dim=(1, 2)) \
                - logdet_tot
            return nll + logq

        z = noise * noise_scale
        for i in reversed(range(self.n_flows)):
            z = flip_channels(z)
            if i > 0:  # the first flow is skipped when sampling
                z = getattr(self, f"flow_{i}")(z, x_mask, g=x, reverse=True)
        z = self.pre_affine(z, x_mask, reverse=True)
        return z[..., :1]
