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
in PyTorch ops; a CUDA tensor launches csrc/mrf.cu (one launch per
(block, dilation): both convs, with u kept on chip) or raises. `plan`
gives each launch's shape and refuses the sizes the kernel does not take.
The kernel's design and bound are in the source's header note.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

EPI_RES, EPI_ADD, EPI_MEAN = 0, 1, 2

# csrc/mrf.cu's tiling: a warp owns 64 rows x 32 channels, C / 32 warps span
# the channels and 8 / (C / 32) the rows. Weights stream through a ring of
# [KS input channels x (C + 8)] tiles, 128-byte aligned after the input
# tile: bf16 3 deep, KS 64 (32 at C = 32); fp32 2 deep, KS 32.
MAX_SMEM = 232448  # bytes of shared memory a block can have on an H100


class Plan(NamedTuple):
    """One (block, dilation) launch: `threads` a block; `rows` conv1 rows a
    block, of which the first `out_rows` conv2 rows are kept; `halo` input
    rows staged on each side of them; `span` input rows staged; `smem`
    dynamic shared-memory bytes."""
    threads: int
    rows: int
    out_rows: int
    halo: int
    span: int
    smem: int


@functools.lru_cache(maxsize=None)
def plan(c: int, k: int, d: int, wdtype: torch.dtype) -> Plan:
    """The launch shape of csrc/mrf.cu:plan for C channels, kernel k,
    dilation d and the weights' type; ValueError where the kernel does
    not take the size."""
    if wdtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf: weights must be float32 or bfloat16, got {wdtype}")
    if c % 32 or not 32 <= c <= 256:
        raise ValueError(f"mrf: the CUDA kernel needs C % 32 == 0 and 32 <= C <= 256, got C={c}")
    if k < 1 or k % 2 == 0 or d < 1:
        raise ValueError(f"mrf: the CUDA kernel needs an odd kernel and dilation >= 1, "
                         f"got k={k}, d={d}")
    wn = c // 32
    wm = 8 // wn
    rows = 64 * wm
    if k - 1 >= rows:
        raise ValueError(f"mrf: kernel {k} is too wide for {rows}-row tiles at C={c}")
    span = rows + (k - 1) * d  # = out_rows + 2 * halo
    esz, x_stride, stages, ks = ((4, c + 4, 2, 32) if wdtype == torch.float32 else
                                 (2, c + 8, 3, 64 if c % 64 == 0 else 32))
    smem = -(-span * x_stride * esz // 128) * 128 + stages * ks * (c + 8) * esz
    if smem > MAX_SMEM:
        raise ValueError(f"mrf: C={c}, k={k}, d={d} needs {smem} bytes of shared memory a "
                         f"block, above {MAX_SMEM}")
    return Plan(32 * wn * wm, rows, rows - (k - 1), (k - 1) // 2 * (d + 1), span, smem)


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
        for d in dils:
            plan(c, k, d, wdt)
    return wdt


def _lib():
    lib = _build.load("mrf")
    if not getattr(lib, "_vc_typed", False):
        lib.mrf_pair.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.mrf_pair.restype = ctypes.c_int
        lib.mrf_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.mrf_plan.restype = ctypes.c_int
        lib._vc_typed = True
    return lib


def kernel_plan(c: int, k: int, d: int, wdtype: torch.dtype) -> Tuple[int, int, int]:
    """(threads, rows, smem) as the built library's mrf_plan gives them, for
    holding `plan` to the C side on the card; ValueError where it refuses."""
    out = [ctypes.c_int() for _ in range(3)]
    err = _lib().mrf_plan(c, k, d, int(wdtype == torch.bfloat16), *(ctypes.byref(v) for v in out))
    if err:
        raise ValueError(f"mrf_plan refuses C={c}, k={k}, d={d}, {wdtype}")
    return tuple(v.value for v in out)


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
    bsz, t_len, c = x.shape
    with _build.device_guard(x.device):
        stream = _build.current_stream(x.device)
        xf = x.float().contiguous()
        hs = (torch.empty_like(xf), torch.empty_like(xf))  # ping-pong: a pair reads its halo
        total = torch.zeros_like(xf)
        inv_n = 1.0 / len(blocks)
        for j, ((w1, b1, w2, b2), k, dils) in enumerate(zip(blocks, kernel_sizes, dilations)):
            src = xf
            for t, d in enumerate(dils):
                if t < len(dils) - 1:
                    out, epi = hs[t % 2], EPI_RES
                else:
                    out, epi = total, (EPI_MEAN if j == len(blocks) - 1 else EPI_ADD)
                err = lib.mrf_pair(src.data_ptr(), w1[t].data_ptr(), b1[t].data_ptr(),
                                   w2[t].data_ptr(), b2[t].data_ptr(), out.data_ptr(), bsz,
                                   t_len, c, k, d, plan(c, k, d, wdt).rows, epi, inv_n, bf16,
                                   stream)
                _build.check(err, "mrf_pair")
                _build.count("mrf")
                src = out
        return total.to(x.dtype)


def launches_per_stage(dilations: Sequence[Sequence[int]]) -> int:
    """Kernel launches `mrf` makes for one stage on a CUDA tensor: one per
    (block, dilation)."""
    return sum(len(d) for d in dilations)
