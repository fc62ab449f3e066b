"""A decoder stage's multi-receptive-field fusion (MRF): kernel K1.

Replaces vcvits_tpu/ops/mrf_pallas.py:mrf_fused / _mrf_kernel. For each
ResBlock1 block (kernel k, dilations d) and each dilation:

    h += conv_k(lrelu(conv_{k,d}(lrelu(h)) + b1) * valid) + b2) * valid

with "same" zero padding, leaky slope 0.1, and the stage's output the mean
of the blocks' final h. Weights come stacked per block as
(w1 [D, k, C, C], b1 [D, C], w2 [D, k, C, C], b2 [D, C]) with the kernel
laid out (tap, in channel, out channel), fp32 or bf16; convolution inputs
are rounded to the weights' type and every sum is fp32, as in the Pallas
kernel.

`mrf` is the wrapper: a CPU tensor goes to `mrf_plain`, the same function
in PyTorch ops; a CUDA tensor launches csrc/mrf.cu (2 launches per
(block, dilation)) or raises. The kernel's design and bound are in the
source's header note.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

EPI_LRELU, EPI_RES, EPI_ADD, EPI_MEAN = 0, 1, 2, 3


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int) -> torch.Tensor:
    """'same' conv of fp32 [B, T, C] with a [k, Cin, Cout] kernel, fp32 sums
    over inputs rounded to the kernel's type."""
    k = w.shape[0]
    p = (k - 1) // 2 * dilation
    xt = x.to(w.dtype).float().transpose(1, 2)
    y = F.conv1d(xt, w.float().permute(2, 1, 0), b.float(), padding=p, dilation=dilation)
    return y.transpose(1, 2)


def mrf_plain(x: torch.Tensor, blocks: Sequence[Block], kernel_sizes: Sequence[int],
              dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """The ResBlock1 loop in PyTorch ops, with the kernel's arithmetic."""
    xf = x.float()
    total = None
    for (w1, b1, w2, b2), dils in zip(blocks, dilations):
        h = xf
        for t, d in enumerate(dils):
            u = F.leaky_relu(_conv(F.leaky_relu(h, 0.1), w1[t], b1[t], d), 0.1)
            h = h + _conv(u, w2[t], b2[t], 1)
        total = h if total is None else total + h
    return (total / float(len(kernel_sizes))).to(x.dtype)


def _check(x: torch.Tensor, blocks: Sequence[Block], kernel_sizes: Sequence[int],
           dilations: Sequence[Sequence[int]]) -> torch.dtype:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"mrf: x must be a contiguous [B, T, C] tensor, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf: x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[2]
    if c % 32 != 0:
        raise ValueError(f"mrf: the CUDA kernel needs C % 32 == 0, got C={c}")
    if not (len(blocks) == len(kernel_sizes) == len(dilations)):
        raise ValueError("mrf: blocks, kernel_sizes and dilations differ in length")
    wdt = blocks[0][0].dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf: weights must be float32 or bfloat16, got {wdt}")
    for (w1, b1, w2, b2), k, dils in zip(blocks, kernel_sizes, dilations):
        n = len(dils)
        for name, t, shape in (("w1", w1, (n, k, c, c)), ("b1", b1, (n, c)),
                               ("w2", w2, (n, k, c, c)), ("b2", b2, (n, c))):
            if tuple(t.shape) != shape or t.dtype != wdt or t.device != x.device \
                    or not t.is_contiguous():
                raise ValueError(f"mrf: {name} must be a contiguous {wdt} {shape} tensor "
                                 f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return wdt


def _launch(lib, src, w, b, res, out, k, d, pre_lrelu, epi, inv_n, bf16, stream) -> None:
    bsz, t, c = src.shape
    err = lib.mrf_conv(src.data_ptr(), w.data_ptr(), b.data_ptr(),
                       res.data_ptr() if res is not None else None, out.data_ptr(),
                       bsz, t, c, k, d, pre_lrelu, epi, inv_n, bf16, stream)
    _build.check(err, "mrf_conv")
    _build.LAUNCHES["mrf"] += 1


def _lib():
    lib = _build.load("mrf")
    if not getattr(lib, "_vc_typed", False):
        lib.mrf_conv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.mrf_conv.restype = ctypes.c_int
        lib._vc_typed = True
    return lib


def mrf(x: torch.Tensor, blocks: Sequence[Block], kernel_sizes: Sequence[int],
        dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """x [B, T, C] -> mean over the blocks of ResBlock1(x); same dtype as x."""
    if x.device.type == "cpu":
        return mrf_plain(x, blocks, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf: unsupported device {x.device}")
    wdt = _check(x, blocks, kernel_sizes, dilations)
    lib = _lib()
    bf16 = int(wdt == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        xf = x.float().contiguous()
        u = torch.empty_like(xf)
        h = torch.empty_like(xf)
        total = torch.zeros_like(xf)
        inv_n = 1.0 / len(blocks)
        for j, ((w1, b1, w2, b2), k, dils) in enumerate(zip(blocks, kernel_sizes, dilations)):
            for t, d in enumerate(dils):
                src = xf if t == 0 else h
                _launch(lib, src, w1[t], b1[t], None, u, k, d, 1, EPI_LRELU, 1.0, bf16, stream)
                if t < len(dils) - 1:
                    out, epi = h, EPI_RES
                else:
                    out, epi = total, (EPI_MEAN if j == len(blocks) - 1 else EPI_ADD)
                _launch(lib, u, w2[t], b2[t], src, out, k, 1, 0, epi, inv_n, bf16, stream)
        return total.to(x.dtype)


def launches_per_stage(dilations: Sequence[Sequence[int]]) -> int:
    """Kernel launches `mrf` makes for one stage on a CUDA tensor."""
    return 2 * sum(len(d) for d in dilations)
