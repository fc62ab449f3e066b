"""Monotonic alignment search (MAS): kernel M1.

Replaces vcvits_tpu/ops/monotonic_align.py:maximum_path, a lax.scan DP
over the spectrogram frames and a backtracking scan (no Pallas kernel).
Per batch row, the path through value[x, y] (text position x, frame y)
that maximises its sum, starting at (0, 0), ending at (T_x - 1, T_y - 1)
of the row's valid region, one x per frame, x stepping by 0 or +1.

* `maximum_path_plain(value, mask)` is JAX's function as PyTorch ops, on
  JAX's arguments (value and mask [B, T_x, T_y]): scores masked to -1e9,
  the strict `diag > stay`, lengths from the mask clamped to >= 1, the
  backtrack's `1 <= y <= y_len - 1` rule, the one-hot path times the mask.
  Every float32 add is JAX's, in its order, so the path is bit-equal.
* `maximum_path(neg_cent, x_lengths, y_lengths)` is the wrapper, on the
  scores in the [B, T_y, T_x] layout in which the synthesizer computes
  them and the rows' lengths (the mask is the outer product of the two
  sequence masks). It returns the path [B, T_x, T_y] in float32. A CPU
  tensor runs the plain version; a CUDA tensor launches csrc/
  monotonic_align.cu once (its design and bound are in the source's
  header note) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vcvits_tpu_torch.ops import _build

NEG_INF = -1e9
MAX_T_X = 2048  # csrc/monotonic_align.cu: 256 threads x 8 positions each


def maximum_path_plain(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """value, mask: [B, T_x, T_y] (mask in {0, 1}) -> the 0/1 path
    [B, T_x, T_y] in value's dtype, JAX's maximum_path step for step."""
    b, t_x, t_y = value.shape
    neg = torch.tensor(NEG_INF, dtype=value.dtype, device=value.device)
    value = torch.where(mask > 0, value, neg)
    x_lengths = torch.clamp_min(mask[:, :, 0].sum(dim=1).to(torch.int64), 1)
    y_lengths = torch.clamp_min(mask[:, 0, :].sum(dim=1).to(torch.int64), 1)

    best = torch.full((b, t_x), NEG_INF, dtype=value.dtype, device=value.device)
    best[:, 0] = value[:, 0, 0]
    from_diag = [torch.zeros(b, t_x, dtype=torch.bool, device=value.device)]
    for y in range(1, t_y):
        diag = torch.cat([neg.expand(b, 1), best[:, :-1]], dim=1)
        fd = diag > best
        best = torch.where(fd, diag, best) + value[:, :, y]
        from_diag.append(fd)

    rows = torch.arange(b, device=value.device)
    x = x_lengths - 1
    x_of_y = [None] * t_y
    for y in range(t_y - 1, -1, -1):
        x_of_y[y] = x
        fd = from_diag[y][rows, torch.where(x < 0, x + t_x, x)]
        active = (y <= y_lengths - 1) & (y >= 1)
        x = x - (active & fd).to(x.dtype)
    x_of_y = torch.stack(x_of_y, dim=1)  # [B, T_y]
    xs = torch.arange(t_x, device=value.device)[None, :, None]
    path = (xs == x_of_y[:, None, :]).to(value.dtype)
    return path * mask.to(value.dtype)


def length_mask(x_lengths: torch.Tensor, y_lengths: torch.Tensor, t_x: int, t_y: int
                ) -> torch.Tensor:
    """The outer product of the two sequence masks, [B, T_x, T_y] float32."""
    dev = x_lengths.device
    mx = torch.arange(t_x, device=dev)[None, :] < x_lengths.to(torch.int64)[:, None]
    my = torch.arange(t_y, device=dev)[None, :] < y_lengths.to(torch.int64)[:, None]
    return (mx[:, :, None] & my[:, None, :]).to(torch.float32)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("monotonic_align")
        lib.monotonic_align.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.monotonic_align.restype = ctypes.c_int
        lib.monotonic_align_shared_bits.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.monotonic_align_shared_bits.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(neg_cent: torch.Tensor, x_lengths: torch.Tensor, y_lengths: torch.Tensor
           ) -> torch.Tensor:
    """One launch on contiguous CUDA float32 neg_cent [B, T_y, T_x] and
    int32 lengths [B] -> path [B, T_x, T_y] float32."""
    b, t_y, t_x = neg_cent.shape
    lib = _lib()
    where = lib.monotonic_align_shared_bits(t_y, t_x)
    if where < 0:
        raise ValueError(f"maximum_path: T_x {t_x} and T_y {t_y} do not fit the kernel's "
                         f"shared memory")
    path = torch.empty(b, t_x, t_y, dtype=torch.float32, device=neg_cent.device)
    bits = None if where else torch.empty(b, t_y, (t_x + 31) // 32, dtype=torch.int32,
                                          device=neg_cent.device)
    with _build.device_guard(neg_cent.device):
        err = lib.monotonic_align(neg_cent.data_ptr(), x_lengths.data_ptr(),
                                  y_lengths.data_ptr(), path.data_ptr(),
                                  None if bits is None else bits.data_ptr(), b, t_y, t_x,
                                  _build.current_stream(neg_cent.device))
    _build.check(err, "monotonic_align")
    _build.count("monotonic_align")
    return path


def maximum_path(neg_cent: torch.Tensor, x_lengths: torch.Tensor, y_lengths: torch.Tensor
                 ) -> torch.Tensor:
    """neg_cent [B, T_y, T_x] float32 scores, x_lengths / y_lengths [B] ->
    the path [B, T_x, T_y] float32 (JAX's maximum_path of
    swapaxes(neg_cent, 1, 2) under the lengths' mask)."""
    if neg_cent.dim() != 3 or x_lengths.shape != (neg_cent.shape[0],) \
            or y_lengths.shape != (neg_cent.shape[0],):
        raise ValueError(f"maximum_path: neg_cent must be [B, T_y, T_x] and the lengths [B], "
                         f"got {tuple(neg_cent.shape)}, {tuple(x_lengths.shape)}, "
                         f"{tuple(y_lengths.shape)}")
    if neg_cent.dtype != torch.float32:
        raise TypeError(f"maximum_path: neg_cent must be float32, got {neg_cent.dtype}")
    b, t_y, t_x = neg_cent.shape
    if neg_cent.device.type == "cpu":
        mask = length_mask(x_lengths, y_lengths, t_x, t_y)
        return maximum_path_plain(neg_cent.transpose(1, 2), mask)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path: unsupported device {neg_cent.device}")
    if x_lengths.device != neg_cent.device or y_lengths.device != neg_cent.device:
        raise ValueError("maximum_path: the lengths must be on neg_cent's device")
    if t_x > MAX_T_X:
        raise ValueError(f"maximum_path: the kernel takes T_x up to {MAX_T_X}, got {t_x}")
    if neg_cent.requires_grad:
        raise ValueError("maximum_path: the kernel has no backward (the path is a constant)")
    return launch(neg_cent.contiguous(), x_lengths.to(torch.int32).contiguous(),
                  y_lengths.to(torch.int32).contiguous())
