"""Masks and nearest-neighbour time interpolation, [B, T, C] layout.

Counterparts of vcvits_tpu/utils/masking.py:sequence_mask and
vcvits_tpu/models/synthesizer.py:nearest_interp. Masks are [B, T, 1] floats.
"""

from __future__ import annotations

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
