"""Masks, segment slicing, nearest-neighbour time interpolation, the
Gaussian KL and sinusoidal position signals, [B, T, C].

Counterparts of vcvits_tpu/utils/masking.py (sequence_mask, slice_segments,
rand_slice_segments, kl_divergence, subsequent_mask, the timing signals,
generate_path) and vcvits_tpu/models/synthesizer.py:nearest_interp. Masks
are [B, T, 1] floats.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] int lengths -> [B, T, 1] float32 mask (1.0 inside, 0.0 padding)."""
    pos = torch.arange(max_length, device=lengths.device)
    mask = pos[None, :] < lengths[:, None].to(torch.int64)
    return mask.to(torch.float32)[:, :, None]


def nearest_interp(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """[B, T_in, C] -> [B, t_out, C], out[j] = in[j * T_in // t_out].

    The integer index of F.interpolate(mode='nearest'), computed exactly in
    integers as the JAX package does (no floating-point scale factor).
    """
    t_in = x.shape[1]
    idx = torch.arange(t_out, device=x.device) * t_in // t_out
    return x[:, idx, :]


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """[B, T, C] -> [B, segment_size, C], row b from ids_str[b], the start
    clipped to [0, T - segment_size] as lax.dynamic_slice does."""
    b, t, _ = x.shape
    start = torch.clamp(ids_str.to(torch.int64), 0, t - segment_size)
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return x[torch.arange(b, device=x.device)[:, None], idx]


def rand_slice_segments(x: torch.Tensor, x_lengths: Optional[torch.Tensor], segment_size: int,
                        generator: Optional[torch.Generator] = None,
                        ids_str: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random segment per row, start = floor(u * max(len - segment_size + 1, 1))
    with u ~ U[0, 1) from `generator` (on x's device); `ids_str` [B] replaces
    the draw. Returns (segments [B, segment_size, C], ids_str [B] int32)."""
    b, t, _ = x.shape
    if ids_str is None:
        if x_lengths is None:
            x_lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        u = torch.rand(b, generator=generator, device=x.device)
        ids_str = segment_starts(u, x_lengths, segment_size)
    ids_str = ids_str.to(device=x.device, dtype=torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


def segment_starts(u: torch.Tensor, lengths: torch.Tensor, segment_size: int) -> torch.Tensor:
    """floor(u * max(len - segment_size + 1, 1)), int32: the segment starts
    of `rand_slice_segments` for its uniform draws `u` [B]."""
    ids_str_max = torch.clamp_min(lengths.to(torch.int32) - segment_size + 1, 1)
    return torch.floor(u * ids_str_max.to(u.dtype)).to(torch.int32)


def kl_divergence(m_p: torch.Tensor, logs_p: torch.Tensor, m_q: torch.Tensor,
                  logs_q: torch.Tensor) -> torch.Tensor:
    """Pointwise KL(P || Q) between diagonal Gaussians."""
    kl = (logs_q - logs_p) - 0.5
    return kl + 0.5 * (torch.exp(2.0 * logs_p) + (m_p - m_q) ** 2) * torch.exp(-2.0 * logs_q)


def subsequent_mask(length: int) -> torch.Tensor:
    """Causal attention mask [1, 1, L, L] float32: 1 where query q may
    attend to key k <= q."""
    return torch.tril(torch.ones(length, length))[None, None]


def get_timing_signal_1d(length: int, channels: int, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """Sinusoidal position signal [1, T, C] float32 (tensor2tensor's layout:
    channels // 2 sines, then channels // 2 cosines, an odd last channel
    zero)."""
    position = torch.arange(length, dtype=torch.float32)
    num = channels // 2
    increment = math.log(float(max_timescale) / float(min_timescale)) / max(num - 1, 1)
    inv = min_timescale * torch.exp(torch.arange(num, dtype=torch.float32) * -increment)
    scaled = position[:, None] * inv[None, :]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    return torch.nn.functional.pad(signal, (0, channels % 2))[None]


def add_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """x + the position signal, x [B, T, C]."""
    _, t, c = x.shape
    return x + get_timing_signal_1d(t, c, min_timescale, max_timescale).to(x)


def cat_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4, axis: int = -1) -> torch.Tensor:
    """x and the position signal concatenated along `axis`, x [B, T, C]."""
    b, t, c = x.shape
    signal = get_timing_signal_1d(t, c, min_timescale, max_timescale).to(x)
    return torch.cat([x, signal.expand(b, t, c)], dim=axis)


def generate_path(duration: torch.Tensor, y_mask: torch.Tensor, x_mask: torch.Tensor
                  ) -> torch.Tensor:
    """Durations -> hard monotonic alignment. duration [B, T_x] integer
    counts, y_mask [B, T_y, 1], x_mask [B, T_x, 1] -> attn [B, T_y, T_x]
    with attn[b, y, x] = 1 where cum[x - 1] <= y < cum[x], masked to the
    valid region, in y_mask's dtype."""
    cum = torch.cumsum(duration.to(torch.int64), dim=1)  # [B, T_x]
    ys = torch.arange(y_mask.shape[1], device=duration.device)[None, :, None]
    upper = ys < cum[:, None, :]
    lower = ys >= torch.nn.functional.pad(cum[:, :-1], (1, 0))[:, None, :]
    attn = (upper & lower).to(y_mask.dtype)
    return attn * y_mask * x_mask[:, None, :, 0]
