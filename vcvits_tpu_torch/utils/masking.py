"""Masks, segment slicing and nearest-neighbour time interpolation, [B, T, C].

Counterparts of vcvits_tpu/utils/masking.py (sequence_mask, slice_segments,
rand_slice_segments, generate_path) and
vcvits_tpu/models/synthesizer.py:nearest_interp. Masks are [B, T, 1] floats.
"""

from __future__ import annotations

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
        ids_str_max = torch.clamp_min(x_lengths.to(torch.int32) - segment_size + 1, 1)
        u = torch.rand(b, generator=generator, device=x.device)
        ids_str = torch.floor(u * ids_str_max.to(u.dtype)).to(torch.int32)
    ids_str = ids_str.to(device=x.device, dtype=torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


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
