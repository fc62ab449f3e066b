"""Gated activation of the WaveNet stacks: kernel K5.

tanh(x[..., :H]) * sigmoid(x[..., H:]) of x = a + b, [B, T, 2H] -> [B, T, H],
with b the speaker term broadcast over time ([B, 1, 2H]) or None, as the
WaveNet stacks pass it. Replaces vcvits_tpu/ops/fused_gate.py:fused_gate_pallas;
`fused_add_tanh_sigmoid_multiply` is the plain version (that file's op).

`fused_gate` is the wrapper: a CPU tensor goes to the plain version; a
CUDA tensor runs csrc/fused_gate.cu through a torch.autograd.Function whose
forward and backward are each one kernel launch (grad_b is the wrapper's
sum of grad_x over the broadcast axis), or raises. It is the training
WaveNets' gate: the no-grad WaveNets run theirs inside kernel K2
(ops/flow_coupling.py). The kernel's bound is in the source's header note.
A launch's host path keeps to the minimum: the typed library is looked up
once, and the device switch and the stream object are skipped
(`_build.device_guard`, `_build.current_stream`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vcvits_tpu_torch.ops import _build


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: Optional[torch.Tensor],
                                    n_channels: int) -> torch.Tensor:
    """tanh(x[:H]) * sigmoid(x[H:]) of x = a + b; [B, T, 2H] -> [B, T, H]."""
    x = a if b is None else a + b
    return torch.tanh(x[..., :n_channels]) * torch.sigmoid(x[..., n_channels:])


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_gate")
        lib.fused_gate_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.fused_gate_bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.fused_gate_fwd.restype = lib.fused_gate_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _vec(dtype: torch.dtype) -> int:
    """Values in the kernel's 16-byte loads."""
    return 8 if dtype == torch.bfloat16 else 4


def _check(a: torch.Tensor, b: Optional[torch.Tensor], n_channels: int) -> None:
    if a.dim() != 3 or a.shape[-1] != 2 * n_channels:
        raise ValueError(f"fused_gate: a must be [B, T, 2*{n_channels}], got {tuple(a.shape)}")
    if b is not None and tuple(b.shape) != (a.shape[0], 1, a.shape[2]):
        raise ValueError(f"fused_gate: b must be [B, 1, 2H] or None for a of shape "
                         f"{tuple(a.shape)}, got {tuple(b.shape)}")


def _rows(a: torch.Tensor, b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """b [B, 1, 2H] as the kernel reads it: contiguous [B, 2H] in a's dtype."""
    if b is None:
        return None
    return _build.aligned16(b.to(a.dtype).reshape(a.shape[0], a.shape[2]).contiguous())


def launch_forward(a: torch.Tensor, b: Optional[torch.Tensor], n_channels: int) -> torch.Tensor:
    """One forward launch on contiguous CUDA a [B, T, 2H] and b as `_rows`
    gives it -> out [B, T, H]."""
    bsz, t, _ = a.shape
    out = torch.empty(bsz, t, n_channels, dtype=a.dtype, device=a.device)
    with _build.device_guard(a.device):
        err = _lib().fused_gate_fwd(
            a.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), bsz, t,
            n_channels, a.dtype == torch.bfloat16, _build.current_stream(a.device))
    _build.check(err, "fused_gate_fwd")
    _build.count("fused_gate")
    return out


def launch_backward(grad_out: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor],
                    n_channels: int) -> torch.Tensor:
    """One backward launch: grad_out [B, T, H] (a's dtype, contiguous) ->
    grad_x [B, T, 2H], the gradient of the gate's input x = a + b."""
    bsz, t, _ = a.shape
    grad_x = torch.empty_like(a)
    with _build.device_guard(a.device):
        err = _lib().fused_gate_bwd(
            grad_out.data_ptr(), a.data_ptr(), None if b is None else b.data_ptr(),
            grad_x.data_ptr(), bsz, t, n_channels, a.dtype == torch.bfloat16,
            _build.current_stream(a.device))
    _build.check(err, "fused_gate_bwd")
    _build.count("fused_gate_backward")
    return grad_x


class _FusedGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor, b: Optional[torch.Tensor], n_channels: int):
        ak, bk = _build.aligned16(a.contiguous()), _rows(a, b)
        out = launch_forward(ak, bk, n_channels)
        ctx.save_for_backward(ak, bk)
        ctx.n_channels = n_channels
        ctx.b_dtype = None if b is None else b.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        ak, bk = ctx.saved_tensors
        grad_x = launch_backward(_build.aligned16(grad_out.to(ak.dtype).contiguous()), ak, bk,
                                 ctx.n_channels)
        grad_b = None
        if bk is not None and ctx.needs_input_grad[1]:
            grad_b = grad_x.float().sum(1, keepdim=True).to(ctx.b_dtype)
        return grad_x, grad_b, None


def fused_gate(a: torch.Tensor, b: Optional[torch.Tensor], n_channels: int) -> torch.Tensor:
    """a [B, T, 2H], b [B, 1, 2H] or None -> [B, T, H] in a's dtype."""
    _check(a, b, n_channels)
    if a.device.type == "cpu":
        return fused_add_tanh_sigmoid_multiply(a, b, n_channels)
    if a.device.type != "cuda":
        raise ValueError(f"fused_gate: unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gate: a must be float32 or bfloat16, got {a.dtype}")
    if n_channels % _vec(a.dtype) or n_channels > 256 * _vec(a.dtype):
        raise ValueError(f"fused_gate: the kernel takes H a multiple of {_vec(a.dtype)} up to "
                         f"{256 * _vec(a.dtype)} for {a.dtype}, got {n_channels}")
    if b is not None and b.device != a.device:
        raise ValueError(f"fused_gate: b on {b.device}, a on {a.device}")
    return _FusedGate.apply(a, b, n_channels)
