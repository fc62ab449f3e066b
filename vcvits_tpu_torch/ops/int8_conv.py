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
  scales; the layers cache one per weight (`W8A8Conv` with its padding,
  bias and dilation).
* `conv1d_w8a8(x, qw, pad, bias, dilation, slope, *, amax, residual,
  accum, divisor, emit, emit_slope)` is the wrapper. `amax` is x's rows'
  max |act(x)| where the caller has it, else Q2 computes it. The epilogue
  then, each step rounded to x's dtype as the decoder's module path rounds
  it: y + residual ([B, T', Co], or [B, 1, Co]: the speaker term), accum
  + y (the blocks' partial sum), y / divisor (the blocks' mean, an IEEE
  division), and emit[b] = max(emit[b], max |leaky_relu(y[b],
  emit_slope)|), the row maximum the next conv quantizes with. A CPU
  tensor goes to `conv1d_w8a8_plain`, which sums the integer codes
  exactly (a float64 conv: |sum| <= 127^2 k Ci < 2^53), does JAX's float32
  dequantization and the epilogue's steps as PyTorch ops; a CUDA tensor
  launches Q1 (csrc/int8_conv.cu:int8_conv1d, the conv with the quantizer
  fused into its loads and the epilogue into its stores), after Q2 where
  `amax` is not given, or raises. `plan` gives a launch's shape and
  refuses the sizes Q1 does not take.
* `row_absmax(x, slope, slots)`: Q2 (csrc/int8_conv.cu:row_absmax), the
  rows' max |act(x)|; with a decode's `slots` ([n, B] float32) it fills
  slot 0 and zeroes the others in the same launch, for the Q1 launches'
  `emit` to fill.
* `mrf_w8a8`: a decoder stage's MRF in W8A8 (ResBlock1 or ResBlock2
  blocks), one Q1 launch a conv: each step's residual add, each block's
  add to the sum and the division by the block count in the epilogue of
  the conv that ends them, each conv's row maximum from the conv that
  wrote its input. Its plain path is the module path's op sequence
  (ResBlock*.module_forward, the block sum, the division) bit for bit.
  models/hifigan.py:HiFiGANGenerator.w8a8_forward drives the whole
  decode: one Q2 on conv_pre's input, then one Q1 a conv (78 for
  configs/48k_base.json).
* `int8_conv1d(x, w, pad, ...)`: JAX's entry point, quantizing `w` at call
  time; `act_quant=False` is "w8": the weights round-trip through the
  int8 grid (`dequantize`) and the conv runs in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

# csrc/int8_conv.cu's constants: the tiles (output frames, columns, warps
# along each), shared memory, padding and the grid's targets
TILES = ((128, 64, 4, 2), (256, 32, 8, 1), (256, 8, 8, 1), (64, 64, 2, 2))
MAX_CI, MAX_CO, MAX_HALO = 512, 4096, 64
MAX_SMEM = 232448
TWO_BLOCKS_SMEM = 113 * 1024
ROW_PAD = 16
SMS, SM_SMEM = 132, 233472  # an H100's SMs, and the shared memory an SM has for its blocks
TARGET_BLOCKS, FEW_FRAMES_BLOCKS = 2 * SMS, SMS


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


def quantize_act_per_row(x: torch.Tensor, slope: Optional[float] = None,
                         amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, C] float activations -> (int8 codes of act(x), [B] float32
    scales), the scales from the rows' max |act(x)| `amax` where given."""
    scale = act_scale(row_absmax_plain(x, slope) if amax is None else amax)
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
    packed = torch.zeros(k, _round_up(co, 64), _round_up(ci, 32), dtype=torch.int8,
                         device=w.device)
    packed[:, :co, :ci] = codes.permute(2, 0, 1)
    return QWeight(packed.contiguous(), scale.contiguous(), co, ci)


class Plan(NamedTuple):
    """One Q1 launch (csrc/int8_conv.cu:plan): the tile (index into TILES),
    column tiles a block covers from one quantized input tile (`nt`),
    blocks along the columns (`groups`), weight chunks (column tile, tap)
    held at once (`ring`; nt * k: the block's whole kernel is resident),
    whether the next frame tile's input is copied into shared memory while
    one is multiplied (`prefetch`), blocks a column group (`persist`: each
    walks the (row, frame tile) pairs), dynamic shared-memory bytes, and
    the padded widths."""
    tile: int
    nt: int
    groups: int
    ring: int
    prefetch: int
    persist: int
    smem: int
    ci_pad: int
    co_pad: int

    def kernel_fields(self) -> Tuple[int, ...]:
        """The fields `kernel_plan` reads back from the built library."""
        return tuple(self[:7])


@functools.lru_cache(maxsize=None)
def plan(ci: int, co: int, k: int, dilation: int, t_out: int = 1, b: int = 1,
         bf16: bool = False) -> Plan:
    """The launch shape of csrc/int8_conv.cu:plan for an output of t_out
    frames and b rows of float32 (or bf16) values; ValueError where Q1
    does not take the size."""
    if not (1 <= ci <= MAX_CI and 1 <= co <= MAX_CO):
        raise ValueError(f"int8_conv1d: the CUDA kernel takes 1 <= Ci <= {MAX_CI} and "
                         f"1 <= Co <= {MAX_CO}, got Ci={ci}, Co={co}")
    if k < 1 or dilation < 1 or (k - 1) * dilation > MAX_HALO:
        raise ValueError(f"int8_conv1d: the CUDA kernel takes (k - 1) * dilation <= "
                         f"{MAX_HALO}, got k={k}, dilation={dilation}")
    if t_out < 1 or not 1 <= b <= 65535:
        raise ValueError(f"int8_conv1d: {b} rows of {t_out} output frames")
    if co <= 8:
        tile = 2
    elif co <= 32:
        tile = 1
    elif -(-t_out // 128) * b < FEW_FRAMES_BLOCKS:
        tile = 3
    else:
        tile = 0
    bm, bn = TILES[tile][:2]
    ci_pad = _round_up(ci, 32)
    rb, es = ci_pad + ROW_PAD, 2 if bf16 else 4
    n_tiles = -(-co // bn)
    items = -(-t_out // bm) * b
    groups = min(-(-TARGET_BLOCKS // items), n_tiles)
    nt = -(-n_tiles // groups)
    groups = -(-n_tiles // nt)
    span = bm + (k - 1) * dilation
    chunk = bn * rb
    fixed = _round_up(span * rb, 16)
    ring = nt * k
    if fixed + ring * chunk > TWO_BLOCKS_SMEM:
        ring = 3 if fixed + 3 * chunk <= TWO_BLOCKS_SMEM else 2
    ring = min(ring, nt * k)
    smem = fixed + ring * chunk
    raw = _round_up(span * ci * es, 16)
    prefetch = int(ring == nt * k and ci * es % 16 == 0 and smem + raw <= TWO_BLOCKS_SMEM)
    smem += raw * prefetch
    if smem > MAX_SMEM:
        raise ValueError(f"int8_conv1d: Ci={ci}, k={k}, dilation={dilation} needs {smem} bytes "
                         f"of shared memory, above {MAX_SMEM}")
    per_sm = 2 if SM_SMEM // (smem + 1024) >= 2 else 1
    persist = min(-(-(SMS * per_sm) // groups), items)
    return Plan(tile, nt, groups, ring, prefetch, persist, smem, ci_pad, _round_up(co, 64))


def _out_len(t: int, k: int, pad: Tuple[int, int], dilation: int) -> int:
    return t + pad[0] + pad[1] - (k - 1) * dilation


def _epilogue_plain(y: torch.Tensor, residual: Optional[torch.Tensor],
                    accum: Optional[torch.Tensor], divisor: Optional[float],
                    emit: Optional[torch.Tensor], emit_slope: Optional[float]) -> torch.Tensor:
    """The fused epilogue's steps as the decoder's module path makes them,
    each in y's dtype: `+ residual`, `accum +`, `/ divisor` (by a tensor:
    an IEEE division on every device), then emit = max(emit, max
    |act(y)|) per row."""
    if residual is not None:
        y = y + residual
    if accum is not None:
        y = accum + y
    if divisor is not None:
        y = y / torch.full((), float(divisor), dtype=torch.float32, device=y.device)
    if emit is not None:
        emit.copy_(torch.maximum(emit, row_absmax_plain(y, emit_slope)))
    return y


def conv1d_w8a8_plain(x: torch.Tensor, qw: QWeight, pad: Tuple[int, int],
                      bias: Optional[torch.Tensor] = None, dilation: int = 1,
                      slope: Optional[float] = None, groups: int = 1, *,
                      amax: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      accum: Optional[torch.Tensor] = None, divisor: Optional[float] = None,
                      emit: Optional[torch.Tensor] = None,
                      emit_slope: Optional[float] = None) -> torch.Tensor:
    """The W8A8 conv in PyTorch ops: exact integer sums in float64, then
    float32(sum) * (a_scale * w_scale) + bias in float32, cast to x's dtype;
    then the fused epilogue's steps (`_epilogue_plain`). `amax`, where
    given, is the rows' max |act(x)| the scale comes from."""
    xq, a_scale = quantize_act_per_row(x, slope, amax)
    xt = F.pad(xq.double().transpose(1, 2), tuple(pad))
    acc = F.conv1d(xt, qw.codes().double(), dilation=dilation, groups=groups).transpose(1, 2)
    y = acc.float() * (a_scale[:, None, None] * qw.scale)
    if bias is not None:
        y = y + bias.float()
    return _epilogue_plain(y.to(x.dtype), residual, accum, divisor, emit, emit_slope)


class _Q1Args(ctypes.Structure):
    """csrc/int8_conv.cu:Q1Args."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "w", "w_scale", "bias", "amax", "y", "res",
                                                  "acc", "emit")]
                + [("res_bstride", ctypes.c_longlong), ("res_tstride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("B", "T", "Ci", "Co", "co_pad", "K", "dil",
                                               "pad_lo", "Tout")]
                + [(n, ctypes.c_float) for n in ("slope", "emit_slope", "divisor")]
                + [(n, ctypes.c_int) for n in ("has_slope", "emit_has_slope", "has_div",
                                               "bf16")])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    if not getattr(lib, "_vc_typed", False):
        lib.int8_conv1d.argtypes = [ctypes.POINTER(_Q1Args), ctypes.c_void_p]
        lib.row_absmax.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.int8_conv_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        lib.int8_conv1d.restype = lib.row_absmax.restype = ctypes.c_int
        lib.int8_conv_plan.restype = ctypes.c_int
        lib._vc_typed = True
    return lib


def kernel_plan(ci: int, co: int, k: int, dilation: int, t_out: int = 1, b: int = 1,
                bf16: bool = False) -> Tuple[int, ...]:
    """Q1's launch shape as the built library's int8_conv_plan gives it
    (`Plan.kernel_fields`), for holding `plan` to the C side on the card;
    ValueError where it refuses."""
    out = (ctypes.c_int * 7)()
    if _lib().int8_conv_plan(ci, co, k, dilation, t_out, b, int(bf16), out):
        raise ValueError(f"int8_conv_plan refuses Ci={ci}, Co={co}, k={k}, dilation={dilation}, "
                         f"T'={t_out}, B={b}")
    return tuple(out)


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, T, C] tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_row_vector(v: torch.Tensor, b: int, device: torch.device, name: str) -> None:
    """A [b] float32 row of maxima on `device` (a slot: a contiguous row of
    a [n, B] buffer, or its own tensor)."""
    if (v.dtype != torch.float32 or tuple(v.shape) != (b,) or v.device != device
            or not v.is_contiguous()):
        raise ValueError(f"int8_conv1d: {name} must be a contiguous float32 [{b}] on {device}")


def row_absmax(x: torch.Tensor, slope: Optional[float] = None,
               slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, C] -> [B] float32 max |act(x[b])|: Q2 on a CUDA tensor, the
    plain version on a CPU one. With `slots` ([n, B] float32, a decode's
    row maxima) the maximum goes into slots[0] and slots[1:] are zeroed in
    the same launch, for the Q1 launches to fill; slots[0] is returned."""
    b = x.shape[0]
    if slots is not None and (slots.dim() != 2 or slots.shape[1] != b or slots.shape[0] < 1
                              or slots.dtype != torch.float32 or not slots.is_contiguous()
                              or slots.device != x.device):
        raise ValueError(f"row_absmax: slots must be a contiguous float32 [n, {b}] on "
                         f"{x.device}")
    if x.device.type == "cpu":
        amax = row_absmax_plain(x, slope)
        if slots is None:
            return amax
        slots.zero_()
        slots[0] = amax
        return slots[0]
    _check_x(x, "row_absmax")
    out = torch.empty(b, dtype=torch.float32, device=x.device) if slots is None else slots[0]
    with _build.device_guard(x.device):
        err = _lib().row_absmax(x.data_ptr(), out.data_ptr(), b, x.numel() // b,
                                1 if slots is None else slots.shape[0],
                                0.0 if slope is None else slope, slope is not None,
                                x.dtype == torch.bfloat16, _build.current_stream(x.device))
    _build.check(err, "row_absmax")
    _build.count("row_absmax")
    return out


def conv1d_w8a8(x: torch.Tensor, qw: QWeight, pad: Tuple[int, int],
                bias: Optional[torch.Tensor] = None, dilation: int = 1,
                slope: Optional[float] = None, *, amax: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None, accum: Optional[torch.Tensor] = None,
                divisor: Optional[float] = None, emit: Optional[torch.Tensor] = None,
                emit_slope: Optional[float] = None) -> torch.Tensor:
    """W8A8 conv of x [B, T, Ci] with a prepared kernel -> [B, T', Co] in x's
    dtype, T' = T + pad[0] + pad[1] - (k - 1) * dilation; the activation
    `slope` (a leaky ReLU) is applied to x first, inside the quantizer.

    `amax` ([B] float32) is x's rows' max |act(x)| where the caller has it
    (a slot Q2 or an earlier launch's `emit` filled); else Q2 computes it.
    The epilogue then, each step in x's dtype: y + residual ([B, T', Co],
    or [B, 1, Co] for a per-row term), accum + y ([B, T', Co]), y /
    divisor, and emit ([B] float32, zeroed by Q2's `slots`) = max(emit,
    max |leaky_relu(y, emit_slope)|) per row."""
    if x.shape[-1] != qw.ci:
        raise ValueError(f"int8_conv1d: x has {x.shape[-1]} channels, the kernel {qw.ci}")
    fused = dict(residual=residual, accum=accum, divisor=divisor, emit=emit,
                 emit_slope=emit_slope)
    if x.device.type == "cpu":
        return conv1d_w8a8_plain(x, qw, pad, bias, dilation, slope, amax=amax, **fused)
    if amax is None:
        amax = row_absmax(x, slope)
    return _launch_conv(x, qw, pad, bias, dilation, slope, amax, **fused)


def _launch_conv(x: torch.Tensor, qw: QWeight, pad: Tuple[int, int],
                 bias: Optional[torch.Tensor], dilation: int, slope: Optional[float],
                 amax: torch.Tensor, residual: Optional[torch.Tensor],
                 accum: Optional[torch.Tensor], divisor: Optional[float],
                 emit: Optional[torch.Tensor], emit_slope: Optional[float]) -> torch.Tensor:
    """One Q1 launch on a CUDA tensor, its arguments checked."""
    _check_x(x, "int8_conv1d")
    b, t_in = x.shape[:2]
    t_out = _out_len(t_in, qw.k, pad, dilation)
    if not 0 <= pad[0] <= (qw.k - 1) * dilation or t_out < 1:
        raise ValueError(f"int8_conv1d: padding {pad} does not fit k={qw.k}, "
                         f"dilation={dilation}, T={t_in}")
    p = plan(qw.ci, qw.co, qw.k, dilation, t_out, b, x.dtype == torch.bfloat16)
    if (tuple(qw.packed.shape) != (qw.k, p.co_pad, p.ci_pad) or qw.packed.device != x.device
            or qw.scale.device != x.device):
        raise ValueError("int8_conv1d: the kernel is not packed for this device and size")
    if bias is not None and (bias.dtype != torch.float32 or bias.numel() != qw.co
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"int8_conv1d: bias must be a contiguous float32 [{qw.co}] on "
                         f"{x.device}")
    _check_row_vector(amax, b, x.device, "amax")
    out_shape = (b, t_out, qw.co)
    res_strides = (0, 0)
    if residual is not None:
        if (residual.dtype != x.dtype or residual.device != x.device or residual.dim() != 3
                or residual.shape[0] != b or residual.shape[2] != qw.co
                or residual.shape[1] not in (1, t_out) or residual.stride(2) != 1):
            raise ValueError(f"int8_conv1d: residual must be a {x.dtype} [{b}, {t_out} or 1, "
                             f"{qw.co}] on {x.device}, the channels contiguous")
        res_strides = (residual.stride(0), 0 if residual.shape[1] == 1 else residual.stride(1))
    if accum is not None and (accum.dtype != x.dtype or accum.device != x.device
                              or tuple(accum.shape) != out_shape or not accum.is_contiguous()):
        raise ValueError(f"int8_conv1d: accum must be a contiguous {x.dtype} {list(out_shape)} "
                         f"on {x.device}")
    if emit is not None:
        _check_row_vector(emit, b, x.device, "emit")
        if emit_slope is not None and emit_slope < 0:  # the kernel keeps each row's extremes
            raise ValueError(f"int8_conv1d: emit_slope must be >= 0, got {emit_slope}")
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    args = _Q1Args(
        x.data_ptr(), qw.packed.data_ptr(), qw.scale.data_ptr(),
        None if bias is None else bias.data_ptr(), amax.data_ptr(), y.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if accum is None else accum.data_ptr(), None if emit is None else emit.data_ptr(),
        res_strides[0], res_strides[1], b, t_in, qw.ci, qw.co, p.co_pad, qw.k, dilation, pad[0],
        t_out, 0.0 if slope is None else slope, 0.0 if emit_slope is None else emit_slope,
        1.0 if divisor is None else float(divisor), slope is not None, emit_slope is not None,
        divisor is not None, x.dtype == torch.bfloat16)
    with _build.device_guard(x.device):
        err = _lib().int8_conv1d(ctypes.byref(args), _build.current_stream(x.device))
    _build.check(err, "int8_conv1d")
    _build.count("int8_conv1d")
    return y


class W8A8Conv(NamedTuple):
    """One W8A8 conv of the decoder as the layers cache it: the packed
    kernel, its (pad_lo, pad_hi), float32 bias or None, dilation."""
    qw: QWeight
    pad: Tuple[int, int]
    bias: Optional[torch.Tensor]
    dilation: int


def mrf_w8a8(x: torch.Tensor, amax: torch.Tensor, blocks: Sequence[Sequence[Sequence[W8A8Conv]]],
             slope: float, slots: Iterator[torch.Tensor], emit: Optional[torch.Tensor] = None,
             emit_slope: Optional[float] = None) -> torch.Tensor:
    """A decoder stage's MRF in W8A8: the mean over `blocks` of each block
    applied to x [B, T, C], one Q1 launch a conv on a CUDA tensor.

    A block is a sequence of steps and a step a chain of convs, each
    quantizing leaky_relu(., slope) of its input, the step's output its
    last conv's plus the step's input: ResBlock1's steps are (c1_i, c2_i),
    ResBlock2's (c_i,). `amax` is x's rows' max |leaky_relu(x, slope)|; the
    maxima of the intermediate outputs go into slots drawn from `slots`
    (rows of a decode's buffer that Q2 zeroed), and the mean's into `emit`
    with `emit_slope`, for the conv after the stage. Each step's residual
    add, each block's add to the sum and the division by the block count
    run in the epilogue of the conv that ends them, in the module path's
    order: the plain path (a CPU tensor) computes exactly
    ResBlock1/2.module_forward, `xs = xs + block(x)` and `xs / count`."""
    n_blocks = len(blocks)
    xs = None
    for j, steps in enumerate(blocks):
        h, h_amax = x, amax
        for s, convs in enumerate(steps):
            step_in = h
            for i, conv in enumerate(convs):
                fused = {}
                if i == len(convs) - 1:  # the step's last conv: its residual add
                    fused["residual"] = step_in
                if i == len(convs) - 1 and s == len(steps) - 1:
                    fused["accum"] = xs  # the block's last: the sum, then the mean
                    if j == n_blocks - 1:
                        fused.update(divisor=float(n_blocks), emit=emit, emit_slope=emit_slope)
                else:  # the next conv's row maximum
                    fused.update(emit=next(slots), emit_slope=slope)
                h = conv1d_w8a8(h, conv.qw, conv.pad, conv.bias, conv.dilation, slope,
                                amax=h_amax, **fused)
                h_amax = fused.get("emit")
        xs = h
    return xs


def mrf_w8a8_slots(blocks: Sequence[Sequence[Sequence[W8A8Conv]]]) -> int:
    """Slots `mrf_w8a8` draws: one per conv but each block's last."""
    return sum(sum(len(c) for c in steps) - 1 for steps in blocks)


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
