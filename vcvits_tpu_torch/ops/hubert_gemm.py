"""HuBERT's dense layers in fp32 as 3xTF32: kernel G1.

y = epilogue(x . W^T + b) for x [M, K] and W [N, K], the epilogue one of
"bias" (y = x W^T + b), "gelu" (F.gelu of that, the exact erf form) or
"residual" (that plus r [M, N]). G1 replaces no TPU kernel: the JAX
package's HuBERT runs flax Dense layers, XLA dots. csrc/hubert_gemm.cu
holds its bound and design.

Both operands are split as a = hi + lo, hi = a rounded to tf32 (10
mantissa bits, to nearest, ties away) and lo = a - hi rounded to tf32 once
more, and y sums lo.hi + hi.lo + hi.hi. `prepare` splits a weight once,
into the layout G1 reads on a CUDA tensor and into (hi, lo) on a CPU one;
the module caches it (`FoldCache.folded`, models/layers.py).
`plain` is the same split arithmetic in plain PyTorch, each product exact
in fp32 and the three sums rounded in fp32.

`dense` is the wrapper: a CPU tensor goes to the plain version; a CUDA
tensor launches G1 on the persistent stream-K grid `plan` picks, or
raises. `engages` is the dispatch rule models/hubert.py applies: G1 runs
when the input and the layer's compute dtype are float32 on a CUDA
device, autocast is off, the layer is not tensor-parallel, nothing needs
a backward (grad mode is off, or neither the input nor a weight requires
grad) and the widths are ones G1 takes (N a multiple of 128, K of 32);
otherwise the layer keeps its F.linear path. `_build.LAUNCHES["hubert_gemm"]`
counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

BM, BN, BK = 128, 128, 32  # G1's output tile and k-block (csrc/hubert_gemm.cu)
EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}
NAME = "hubert_gemm"

# plan's cost model, in k-blocks of one block's work: the ring's fill and
# the epilogue of a block's range, and a partial tile parked and read back
FILL_KB, PIECE_KB = 2.0, 0.6


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 a rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero: cvt.rna.tf32.f32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    """fp32 a as (hi, lo), both tf32: a - hi rounded once more."""
    hi = tf32_round(a.float())
    return hi, tf32_round(a.float() - hi)


def _swizzle(rows: int, device) -> torch.Tensor:
    """[rows, 8]: the 16-byte chunk of a 128-byte row that lands in position
    c of row r under the 128-byte swizzle, c ^ (r % 8)."""
    r = torch.arange(rows, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (r % 8)


def tile(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) [N, K] -> G1's layout [N / BN, K / BK, 2, BN * BK]: for each
    column tile and k-block, hi's [BN, BK] tile then lo's, each row 32 floats
    (128 bytes) with its 16-byte chunks swizzled as a 128-byte TMA swizzle
    lays them (chunk c of row r at c ^ (r % 8))."""
    n, k = hi.shape
    t = torch.stack([hi, lo]).reshape(2, n // BN, BN, k // BK, BK // 4, 4)
    t = t.permute(1, 3, 0, 2, 4, 5)  # [nt, kb, half, r, chunk, 4]
    idx = _swizzle(BN, hi.device)[None, None, None, :, :, None].expand(t.shape)
    return torch.gather(t, 4, idx).reshape(n // BN, k // BK, 2, BN * BK).contiguous()


class Prepared(NamedTuple):
    """A split weight W [n, k]: G1's tiles on a CUDA device, else (hi, lo)
    stacked [2, n, k]."""
    n: int
    k: int
    data: torch.Tensor


def takes(n: int, k: int) -> bool:
    """Whether G1 takes a weight [n, k]."""
    return n >= BN and n % BN == 0 and k >= BK and k % BK == 0


def prepare(w: torch.Tensor) -> Prepared:
    """W [N, K] split once: G1's tiles on a CUDA device (raises on widths it
    does not take), (hi, lo) elsewhere."""
    n, k = w.shape
    hi, lo = split(w.detach())
    if w.is_cuda:
        if not takes(n, k):
            raise ValueError(f"hubert_gemm: G1 takes a weight [N, K] with N a multiple of {BN} "
                             f"and K of {BK}, got [{n}, {k}]")
        return Prepared(n, k, tile(hi, lo))
    return Prepared(n, k, torch.stack([hi, lo]))


def _epilogue(y: torch.Tensor, bias: Optional[torch.Tensor], epilogue: str,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is not None:
        y = y + bias
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "residual":
        return y + residual
    return y


def plain(x: torch.Tensor, w: Prepared, bias: Optional[torch.Tensor] = None,
          epilogue: str = "bias", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G1's arithmetic in plain PyTorch on x [M, K] and a CPU `Prepared`:
    (lo.hi + hi.lo) + hi.hi in fp32, then the epilogue."""
    hi, lo = w.data[0], w.data[1]
    xh, xl = split(x)
    y = (F.linear(xl, hi) + F.linear(xh, lo)) + F.linear(xh, hi)
    return _epilogue(y, bias, epilogue, residual)


def on_card(x: torch.Tensor) -> bool:
    """Whether x lies where G1 runs."""
    return x.is_cuda


def engages(x: torch.Tensor, linears: Sequence, widths_ok: bool) -> bool:
    """Whether a layer's dense products, `linears` (models/layers.Linear,
    their weights on one device), run on G1 for input x: the dispatch rule
    of the module docstring. `widths_ok` is `takes` over their weights,
    which the layer computes once."""
    if not (on_card(x) and widths_ok and x.dtype == torch.float32) or \
            torch.is_autocast_enabled("cuda") or linears[0].weight.device != x.device:
        return False
    for lin in linears:
        if lin.dtype != torch.float32 or lin.tp is not None:
            return False
    return not (torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for lin in linears for p in lin.parameters())))


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, sms: int) -> int:
    """The number of persistent blocks for an [m, k] x [n, k]^T product on
    `sms` SMs: groups of one block a row tile (the kernel's walk), as many
    groups as give the least estimated time, in k-blocks of one block, of
    the longest range, its fill and its parked pieces."""
    row_tiles, col_tiles, kbs = math.ceil(m / BM), n // BN, k // BK
    total = col_tiles * kbs
    best, best_cost = 1, float("inf")
    for groups in range(1, max(1, min(sms // row_tiles, total)) + 1):
        per = total // groups
        whole = groups <= col_tiles and col_tiles % groups == 0
        n_pieces = 0 if whole else math.ceil(kbs / per) + 1
        cost = math.ceil(total / groups) + FILL_KB + PIECE_KB * n_pieces
        if cost < best_cost:
            best, best_cost = groups, cost
    return best * row_tiles


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(NAME)
        lib.hubert_gemm.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.hubert_gemm.restype = ctypes.c_int
        lib.hubert_gemm_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class _Scratch:
    """A stream's workspace (two partial tiles a block) and tile counters
    (left at 0 by every launch), reused by the launches on that stream,
    which the stream orders; both grow on demand."""

    def __init__(self, device: torch.device, sms: int):
        self.sms = sms
        self.ws = torch.empty(2 * sms, BM * BN, dtype=torch.float32, device=device)
        self.counters = torch.zeros(256, dtype=torch.int32, device=device)

    def get(self, grid: int, tiles: int):
        if self.ws.shape[0] < 2 * grid:
            self.ws = torch.empty(2 * grid, BM * BN, dtype=torch.float32, device=self.ws.device)
        if self.counters.numel() < tiles:
            self.counters = torch.zeros(max(tiles, 2 * self.counters.numel()),
                                        dtype=torch.int32, device=self.ws.device)
        return self.ws, self.counters


_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def _scratch(device: torch.device, stream: int) -> _Scratch:
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (index, stream)
    s = _SCRATCH.get(key)
    if s is None:
        with _SCRATCH_LOCK:
            s = _SCRATCH.get(key)
            if s is None:
                sms = torch.cuda.get_device_properties(index).multi_processor_count
                s = _SCRATCH[key] = _Scratch(torch.device("cuda", index), sms)
    return s


def launch(x: torch.Tensor, w: Prepared, bias: Optional[torch.Tensor], epilogue: str,
           residual: Optional[torch.Tensor]) -> torch.Tensor:
    """One G1 launch on checked CUDA operands: x [M, K] and residual [M, N]
    contiguous and 16-byte aligned, bias [N] contiguous or None."""
    m = x.shape[0]
    out = torch.empty(m, w.n, dtype=torch.float32, device=x.device)
    with _build.device_guard(x.device):
        stream = _build.current_stream(x.device)
        s = _scratch(x.device, stream)
        grid = plan(m, w.n, w.k, s.sms)
        ws, counters = s.get(grid, math.ceil(m / BM) * (w.n // BN))
        err = _lib().hubert_gemm(
            x.data_ptr(), w.data.data_ptr(), None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), m, w.n, w.k, grid, EPILOGUES[epilogue], stream)
    _build.check(err, NAME)
    _build.count(NAME)
    return out


def dense(x: torch.Tensor, w: Prepared, bias: Optional[torch.Tensor] = None,
          epilogue: str = "bias", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(x [M, K] . W^T + bias) -> [M, N]: the plain version on the
    CPU, G1 on a CUDA device (or a ValueError / TypeError). The checks are
    the host's cost of every launch, 4 a layer: kept to plain comparisons."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"hubert_gemm: unknown epilogue {epilogue!r}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("hubert_gemm: a residual goes with the \"residual\" epilogue alone")
    if x.dim() != 2 or x.shape[1] != w.k or (residual is not None and (
            residual.shape[0] != x.shape[0] or residual.shape[1] != w.n)):
        raise ValueError(f"hubert_gemm: x must be [M, {w.k}] and a residual [M, {w.n}], got "
                         f"{tuple(x.shape)} and "
                         f"{None if residual is None else tuple(residual.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return run(x, w, bias, epilogue, residual)
        raise ValueError(f"hubert_gemm: unsupported device {x.device}")
    f32, dev, data = torch.float32, x.device, w.data
    if x.dtype != f32 or data.dtype != f32 or (bias is not None and bias.dtype != f32) or (
            residual is not None and residual.dtype != f32):
        raise TypeError("hubert_gemm: G1 takes float32 operands")
    if data.device != dev or (bias is not None and bias.device != dev) or (
            residual is not None and residual.device != dev):
        raise ValueError("hubert_gemm: the operands lie on different devices")
    if torch.is_grad_enabled() and (x.requires_grad or data.requires_grad or (
            bias is not None and bias.requires_grad) or (
            residual is not None and residual.requires_grad)):
        raise ValueError("hubert_gemm: G1 has no backward")
    if not takes(w.n, w.k) or data.shape != (w.n // BN, w.k // BK, 2, BN * BK):
        raise ValueError(f"hubert_gemm: G1 takes a prepared weight [N, K] with N a multiple of "
                         f"{BN} and K of {BK}, got [{w.n}, {w.k}]")
    if bias is not None and (bias.dim() != 1 or bias.shape[0] != w.n):
        raise ValueError(f"hubert_gemm: bias must be [{w.n}], got {tuple(bias.shape)}")
    if x.shape[0] == 0:
        return x.new_empty(0, w.n)
    return run(x.contiguous(), w, None if bias is None else bias.contiguous(), epilogue,
               None if residual is None else residual.contiguous())


def run(x: torch.Tensor, w: Prepared, bias: Optional[torch.Tensor], epilogue: str,
        residual: Optional[torch.Tensor]) -> torch.Tensor:
    """`dense` without its checks, for a caller whose operands meet them by
    construction (models/hubert.py's layers, under the rule): contiguous
    float32 x [M >= 1, K], residual [M, N] and bias [N] on one device. The
    plain version on the CPU, G1 on a CUDA device."""
    if not x.is_cuda:
        return plain(x, w, bias, epilogue, residual)
    return launch(_build.aligned16(x), w, bias, epilogue,
                  None if residual is None else _build.aligned16(residual))
