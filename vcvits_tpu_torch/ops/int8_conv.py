"""The int8 decoder convolutions: dynamic W8A8 (kernels Q1 and Q2) and the
weight-only "w8" mode.

Counterpart of vcvits_tpu/ops/int8_conv.py. Symmetric int8 grids:

    w_scale[o] = max(max |W[o]|, 1e-12) / 127          per output column
    a_scale[b] = max(max |act(x[b])|, 1e-12) / 127     per batch row, over all T and C
    y = float32(conv(q(act(x)), q(W))) * (a_scale * w_scale) + bias

with q(v) = clip(round(float32(v) / scale), -127, 127), round half to even
after an IEEE division, and act the identity or a leaky ReLU applied in
x's dtype first (the decoder's lrelu before each conv, fused here). A
row's scale covers its padded tail too, so a W8A8 output depends on the
length its batch is padded to, as in JAX. Weights are PyTorch-layout
[Co, Ci, k] kernels; a transposed conv comes phase-decomposed
(models/layers.py), its columns (phase, channel) each with its own scale.

* `quantize_weight_per_channel`, `quantize_act_per_row`: the quantizers.
* `QWeight` / `prepare_w8a8`: a kernel's codes, packed as Q1 reads them
  ([k, Co rounded up to 64, Ci rounded up to 32], zero-padded), and its
  scales; the layers cache one per weight.
* `conv1d_w8a8(x, qw, pad, bias, dilation, slope)` is the wrapper: a CPU
  tensor goes to `conv1d_w8a8_plain`, which sums the integer codes exactly
  (a float64 conv: |sum| <= 127^2 k Ci < 2^53) and then does JAX's float32
  dequantization; a CUDA tensor launches Q2 (csrc/int8_conv.cu:row_absmax,
  the rows' max |act(x)|) and Q1 (csrc/int8_conv.cu:int8_conv1d, the conv
  with the quantizer fused into its loads), or raises. `plan` refuses the
  sizes Q1 does not take.
* `int8_conv1d(x, w, pad, ...)`: JAX's entry point, quantizing `w` at call
  time; `act_quant=False` is "w8": the weights round-trip through the
  int8 grid (`dequantize`) and the conv runs in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

BM, BN = 128, 64  # csrc/int8_conv.cu: output frames and columns a block
MAX_CI, MAX_CO, MAX_HALO = 512, 4096, 64
MAX_SMEM = 232448
ROW_PAD = 16


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in float32, an IEEE division: PyTorch divides
    a CUDA tensor by a host scalar as a product with its reciprocal, which
    is off by an ulp for some values, so the divisor is a tensor."""
    amax = torch.clamp_min(amax, 1e-12)
    return amax / torch.full_like(amax, 127.0)


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Co, ...] float kernel -> (int8 codes of its shape, [Co] float32 scales)."""
    wf = w.float()
    scale = _scale(wf.abs().reshape(wf.shape[0], -1).amax(dim=1))
    codes = torch.round(wf / scale.reshape(-1, *([1] * (wf.dim() - 1)))).clamp(-127, 127)
    return codes.to(torch.int8), scale


def activation(x: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    """The quantizer's input: x, or leaky_relu(x, slope) in x's dtype."""
    return x if slope is None else F.leaky_relu(x, slope)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """[B] max |act(x[b])| -> [B] float32 scales."""
    return _scale(amax)


def row_absmax_plain(x: torch.Tensor, slope: Optional[float] = None) -> torch.Tensor:
    """[B, ...] -> [B] float32 max |act(x[b])|: the plain version of Q2."""
    return activation(x, slope).float().abs().reshape(x.shape[0], -1).amax(dim=1)


def quantize_act_per_row(x: torch.Tensor, slope: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, C] float activations -> (int8 codes of act(x), [B] float32 scales)."""
    scale = act_scale(row_absmax_plain(x, slope))
    xf = activation(x, slope).float()
    codes = torch.round(xf / scale.reshape(-1, *([1] * (x.dim() - 1)))).clamp(-127, 127)
    return codes.to(torch.int8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Codes [Co, ...] back to `dtype` on their float32 grid, as "w8" runs them."""
    return (codes.float() * scale.reshape(-1, *([1] * (codes.dim() - 1)))).to(dtype)


class QWeight(NamedTuple):
    """A quantized kernel: `packed` int8 [k, round_up(Co, 64), round_up(Ci, 32)]
    as (tap, out, in), zero where padded; `scale` float32 [Co]."""
    packed: torch.Tensor
    scale: torch.Tensor
    co: int
    ci: int

    @property
    def k(self) -> int:
        return self.packed.shape[0]

    def codes(self) -> torch.Tensor:
        """The codes in the kernel's layout [Co, Ci, k]."""
        return self.packed[:, :self.co, :self.ci].permute(1, 2, 0)

    def to(self, device) -> "QWeight":
        return QWeight(self.packed.to(device), self.scale.to(device), self.co, self.ci)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def prepare_w8a8(w: torch.Tensor) -> QWeight:
    """Quantize a [Co, Ci, k] kernel per output column and pack it for Q1."""
    co, ci, k = w.shape
    codes, scale = quantize_weight_per_channel(w)
    packed = torch.zeros(k, _round_up(co, BN), _round_up(ci, 32), dtype=torch.int8,
                         device=w.device)
    packed[:, :co, :ci] = codes.permute(2, 0, 1)
    return QWeight(packed.contiguous(), scale.contiguous(), co, ci)


class Plan(NamedTuple):
    """One Q1 launch: padded widths, input rows a block stages, and the
    dynamic shared-memory bytes."""
    ci_pad: int
    co_pad: int
    span: int
    smem: int


@functools.lru_cache(maxsize=None)
def plan(ci: int, co: int, k: int, dilation: int) -> Plan:
    """The launch shape of csrc/int8_conv.cu:plan; ValueError where Q1 does
    not take the size."""
    if not (1 <= ci <= MAX_CI and 1 <= co <= MAX_CO):
        raise ValueError(f"int8_conv1d: the CUDA kernel takes 1 <= Ci <= {MAX_CI} and "
                         f"1 <= Co <= {MAX_CO}, got Ci={ci}, Co={co}")
    if k < 1 or dilation < 1 or (k - 1) * dilation > MAX_HALO:
        raise ValueError(f"int8_conv1d: the CUDA kernel takes (k - 1) * dilation <= "
                         f"{MAX_HALO}, got k={k}, dilation={dilation}")
    ci_pad = _round_up(ci, 32)
    span = BM + (k - 1) * dilation
    smem = (span + 2 * BN) * (ci_pad + ROW_PAD)
    if smem > MAX_SMEM:
        raise ValueError(f"int8_conv1d: Ci={ci}, k={k}, dilation={dilation} needs {smem} bytes "
                         f"of shared memory, above {MAX_SMEM}")
    return Plan(ci_pad, _round_up(co, BN), span, smem)


def _out_len(t: int, k: int, pad: Tuple[int, int], dilation: int) -> int:
    return t + pad[0] + pad[1] - (k - 1) * dilation


def conv1d_w8a8_plain(x: torch.Tensor, qw: QWeight, pad: Tuple[int, int],
                      bias: Optional[torch.Tensor] = None, dilation: int = 1,
                      slope: Optional[float] = None, groups: int = 1) -> torch.Tensor:
    """The W8A8 conv in PyTorch ops: exact integer sums in float64, then
    float32(sum) * (a_scale * w_scale) + bias in float32, cast to x's dtype."""
    xq, a_scale = quantize_act_per_row(x, slope)
    xt = F.pad(xq.double().transpose(1, 2), tuple(pad))
    acc = F.conv1d(xt, qw.codes().double(), dilation=dilation, groups=groups).transpose(1, 2)
    y = acc.float() * (a_scale[:, None, None] * qw.scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("int8_conv")
        lib.int8_conv1d.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.row_absmax.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.int8_conv_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.int8_conv1d.restype = lib.row_absmax.restype = ctypes.c_int
        lib.int8_conv_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_plan(ci: int, co: int, k: int, dilation: int) -> int:
    """Q1's shared-memory bytes as the built library's int8_conv_plan gives
    them, for holding `plan` to the C side on the card; ValueError where it
    refuses."""
    smem = ctypes.c_int()
    if _lib().int8_conv_plan(ci, co, k, dilation, ctypes.byref(smem)):
        raise ValueError(f"int8_conv_plan refuses Ci={ci}, Co={co}, k={k}, dilation={dilation}")
    return smem.value


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, T, C] tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def row_absmax(x: torch.Tensor, slope: Optional[float] = None) -> torch.Tensor:
    """[B, T, C] -> [B] float32 max |act(x[b])|: Q2 on a CUDA tensor, the
    plain version on a CPU one."""
    if x.device.type == "cpu":
        return row_absmax_plain(x, slope)
    _check_x(x, "row_absmax")
    amax = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    with _build.device_guard(x.device):
        err = _lib().row_absmax(x.data_ptr(), amax.data_ptr(), x.shape[0],
                                x.numel() // x.shape[0], 0.0 if slope is None else slope,
                                slope is not None, x.dtype == torch.bfloat16,
                                _build.current_stream(x.device))
    _build.check(err, "row_absmax")
    _build.count("row_absmax")
    return amax


def conv1d_w8a8(x: torch.Tensor, qw: QWeight, pad: Tuple[int, int],
                bias: Optional[torch.Tensor] = None, dilation: int = 1,
                slope: Optional[float] = None) -> torch.Tensor:
    """W8A8 conv of x [B, T, Ci] with a prepared kernel -> [B, T', Co] in x's
    dtype, T' = T + pad[0] + pad[1] - (k - 1) * dilation; the activation
    `slope` (a leaky ReLU) is applied to x first, inside the quantizer."""
    if x.shape[-1] != qw.ci:
        raise ValueError(f"int8_conv1d: x has {x.shape[-1]} channels, the kernel {qw.ci}")
    if x.device.type == "cpu":
        return conv1d_w8a8_plain(x, qw, pad, bias, dilation, slope)
    return launch_conv(x, qw, pad, bias, dilation, slope, row_absmax(x, slope))


def launch_conv(x: torch.Tensor, qw: QWeight, pad: Tuple[int, int],
                bias: Optional[torch.Tensor], dilation: int, slope: Optional[float],
                amax: torch.Tensor) -> torch.Tensor:
    """One Q1 launch on a CUDA tensor, given its rows' max |act(x)| `amax`
    (from `row_absmax`)."""
    _check_x(x, "int8_conv1d")
    p = plan(qw.ci, qw.co, qw.k, dilation)
    t_out = _out_len(x.shape[1], qw.k, pad, dilation)
    if not 0 <= pad[0] <= (qw.k - 1) * dilation or t_out < 1:
        raise ValueError(f"int8_conv1d: padding {pad} does not fit k={qw.k}, "
                         f"dilation={dilation}, T={x.shape[1]}")
    if tuple(qw.packed.shape) != (qw.k, p.co_pad, p.ci_pad) or qw.packed.device != x.device:
        raise ValueError("int8_conv1d: the kernel is not packed for this device and size")
    if bias is not None and (bias.dtype != torch.float32 or bias.numel() != qw.co
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"int8_conv1d: bias must be a contiguous float32 [{qw.co}] on "
                         f"{x.device}")
    if amax.dtype != torch.float32 or amax.shape != (x.shape[0],) or amax.device != x.device:
        raise ValueError(f"int8_conv1d: amax must be a float32 [{x.shape[0]}] on {x.device}")
    y = torch.empty(x.shape[0], t_out, qw.co, dtype=x.dtype, device=x.device)
    with _build.device_guard(x.device):
        err = _lib().int8_conv1d(
            x.data_ptr(), qw.packed.data_ptr(), qw.scale.data_ptr(),
            None if bias is None else bias.data_ptr(), amax.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], qw.ci, qw.co, qw.k, dilation, pad[0], t_out,
            0.0 if slope is None else slope, slope is not None, x.dtype == torch.bfloat16,
            _build.current_stream(x.device))
    _build.check(err, "int8_conv1d")
    _build.count("int8_conv1d")
    return y


def int8_conv1d(x: torch.Tensor, w: torch.Tensor, pad: Tuple[int, int],
                bias: Optional[torch.Tensor] = None, dilation: int = 1, groups: int = 1,
                act_quant: bool = True, slope: Optional[float] = None) -> torch.Tensor:
    """JAX's int8_conv1d on [B, T, Ci] with a float [Co, Ci/groups, k] kernel,
    quantized at call time: W8A8 (`act_quant`), or "w8" (weights on the int8
    grid, the conv in x's dtype, float32 bias added and cast back). The
    CUDA kernel takes groups = 1."""
    if not act_quant:
        wq = dequantize(*quantize_weight_per_channel(w), x.dtype)
        xt = F.pad(activation(x, slope).transpose(1, 2), tuple(pad))
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":  # see models/layers.conv_op
            y = F.conv1d(xt.float(), wq.float(), dilation=dilation, groups=groups)
            y = y.to(x.dtype)
        else:
            y = F.conv1d(xt, wq, dilation=dilation, groups=groups)
        y = y.transpose(1, 2).float()
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)
    qw = prepare_w8a8(w)
    if groups != 1:
        if x.device.type != "cpu":
            raise ValueError("int8_conv1d: the CUDA kernel takes groups = 1")
        return conv1d_w8a8_plain(x, qw, pad, bias, dilation, slope, groups)
    return conv1d_w8a8(x, qw, pad, None if bias is None else bias.float().contiguous(),
                       dilation, slope)
