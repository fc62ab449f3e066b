"""Gated activation of the WaveNet stacks: tanh(x[:H]) * sigmoid(x[H:]).

The plain op of vcvits_tpu/ops/fused_gate.py:fused_add_tanh_sigmoid_multiply.
That file's Pallas kernel (`fused_gate_pallas`) is wired into no model path
and is still to be ported; here the gate also runs inside the flow-coupling
kernel (ops/flow_coupling.py).
"""

from __future__ import annotations

import torch


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor,
                                    n_channels: int) -> torch.Tensor:
    """tanh(x[:H]) * sigmoid(x[H:]) of x = a + b; [B, T, 2H] -> [B, T, H]."""
    x = a + b
    return torch.tanh(x[..., :n_channels]) * torch.sigmoid(x[..., n_channels:])
