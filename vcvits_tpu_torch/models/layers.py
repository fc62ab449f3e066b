"""Primitive layers, [B, T, C] layout at every public forward.

Counterparts of vcvits_tpu/models/layers.py. Convolutions transpose to
PyTorch's [B, C, T] inside and run `F.conv1d` / `F.conv_transpose1d`.

* Parameters are held in float32 and cast to the module's compute `dtype`
  at call time, as the flax modules do (params fp32, `dtype` for compute).
* Weight norm keeps explicit `v` / `g` parameters and folds
  `g * v / ||v||` per call, the norm taken over every axis except the
  output channel (`Conv1d`) or the input channel (`ConvTranspose1d`, whose
  PyTorch weight is [in, out, k]).
* A bfloat16 convolution on the CPU runs as a float32 convolution of the
  bf16 operands, rounded to bf16 once (`conv_op`): the arithmetic of a
  bf16 conv that accumulates in float32, and torch's CPU bf16 conv is
  wrong at some shapes (kernel 8 or 128 with 4 or 8 channels a group, in
  torch 2.13: errors as large as the outputs). On the card cuDNN runs it.
* The decoder's `Conv1d` / `ConvTranspose1d` take `quant_int8` (JAX's int8
  modes, ops/int8_conv.py); their int8 weights are folded and quantized
  once on the host and cached (`host_kernel`, `FoldCache`).
* Under tensor parallelism (parallel/mesh.py:shard_params_tp) a layer
  holds a slice of its kernel and a `Shard` in `tp`: `Linear` is column-
  (q/k/v/fc1: its output stays sliced) or row-parallel (out_proj/fc2: a
  sliced input, the partial outputs summed); `Conv1d` and `Conv2dNorm`
  compute their slice of output channels and gather them, weight norm
  folded with this rank's slice of `g`; `ConvTranspose1d` is
  row-parallel on its input channels. `kernel()` gathers the whole kernel
  for the fused kernels that take whole weights (K2's WaveNet stack).
* Every leaf module has `reset_parameters(generator)` mirroring the JAX
  package's initialiser for that parameter, so `init_weights(model, seed)`
  gives a seeded model with no checkpoint.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.ops import int8_conv
from vcvits_tpu_torch.ops.int8_conv import (
    W8A8Conv, dequantize, prepare_w8a8, quantize_weight_per_channel)
from vcvits_tpu_torch.parallel.tp import copy_to, gather, reduce_from, split

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


_ROWS = threading.local()


@contextlib.contextmanager
def dropout_rows(lo: int, hi: int, total: int):
    """Within it, every `dropout` draws its mask for a batch of `total` rows
    and keeps rows [lo, hi): a data-parallel rank holding those rows of
    the global batch draws what the one-process step draws for them."""
    prev = getattr(_ROWS, "rows", None)
    _ROWS.rows = (lo, hi, total)
    try:
        yield
    finally:
        _ROWS.rows = prev


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout: keep each element with probability 1-rate and scale
    it by 1/(1-rate); the identity when deterministic or rate == 0. The keep
    mask is drawn from `generator` (on x's device), or the default one, for
    the global batch under `dropout_rows`."""
    if deterministic or rate == 0.0:
        return x
    rows = getattr(_ROWS, "rows", None)
    if rows is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        lo, hi, total = rows
        if x.shape[0] != hi - lo:
            raise ValueError(f"dropout on {x.shape[0]} rows under dropout_rows({lo}, {hi})")
        keep = torch.rand((total, *x.shape[1:]), generator=generator,
                          device=x.device)[lo:hi] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def conv_op(op, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], **kwargs
            ) -> torch.Tensor:
    """`op(x, w, b, **kwargs)` (F.conv1d, F.conv_transpose1d, F.conv2d); in
    bfloat16 on the CPU as float32 on the bf16 operands, rounded once."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        y = op(x.float(), w.float(), None if b is None else b.float(), **kwargs)
        return y.to(torch.bfloat16)
    return op(x, w, b, **kwargs)


def torch_same_padding(kernel_size: int, dilation: int = 1) -> Tuple[int, int]:
    """Symmetric PyTorch-style padding for odd kernels."""
    p = (kernel_size * dilation - dilation) // 2
    return (p, p)


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * std)


def _fill_kernel(p: torch.Tensor, init: str, fan_in: int, gen: torch.Generator) -> None:
    """The JAX package's kernel initialisers, by name."""
    if init == "lecun_normal":
        _normal_(p, 1.0 / math.sqrt(fan_in), gen)
    elif init == "he_normal":
        _normal_(p, math.sqrt(2.0 / fan_in), gen)
    elif init == "normal":  # HiFi-GAN's init_weights: N(0, 0.01)
        _normal_(p, 0.01, gen)
    elif init == "zeros":
        with torch.no_grad():
            p.zero_()
    else:
        raise ValueError(f"unknown kernel init {init!r}")


def _norm_except(v: torch.Tensor, dim: int) -> torch.Tensor:
    dims = tuple(i for i in range(v.ndim) if i != dim)
    return torch.sqrt(torch.sum(v.float() ** 2, dim=dims, keepdim=True))


class LayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis, statistics in float32."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class Linear(nn.Module):
    """flax `nn.Dense` as a PyTorch linear layer: weight [out, in]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 kernel_init: str = "lecun_normal", dtype=torch.float32):
        super().__init__()
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        if self.kernel_init == "xavier_uniform":
            lim = math.sqrt(6.0 / (in_f + out_f))
            with torch.no_grad():
                self.weight.copy_((torch.rand(self.weight.shape, generator=gen, device=gen.device)
                                   * 2 - 1) * lim)
        else:
            _fill_kernel(self.weight, self.kernel_init, in_f, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    tp = None  # a Shard under tensor parallelism (parallel/mesh.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        if self.tp.kind == "col":  # a slice of the outputs (and of the bias)
            return F.linear(copy_to(x.to(dt), self.tp), self.weight.to(dt), b)
        # row: x holds this rank's slice of the inputs
        y = reduce_from(F.linear(x.to(dt), self.weight.to(dt)), self.tp)
        return y if b is None else y + b


class Embedding(nn.Module):
    """flax `nn.Embed`: a [num, features] table, looked up in `dtype`."""

    def __init__(self, num: int, features: int, std: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.std = std
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.weight, self.std, gen)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight).to(self.dtype)


def spectral_normalize(weight: torch.Tensor, n_iter: int = 3) -> torch.Tensor:
    """weight / sigma_max, the spectral-norm parametrisation as the JAX
    package computes it: `n_iter` power iterations from the fixed uniform
    start vector on every call (no persistent `u`, unlike
    torch.nn.utils.spectral_norm), gradients through sigma. `weight` has
    the output channel first; sigma_max does not depend on how the other
    axes are flattened."""
    out = weight.shape[0]
    w = weight.reshape(out, -1).t().float()
    u = torch.full((out,), 1.0 / math.sqrt(out), dtype=torch.float32, device=weight.device)
    for _ in range(n_iter):
        v = w @ u
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-12)
        u = w.t() @ v
        u = u / torch.clamp_min(torch.linalg.vector_norm(u), 1e-12)
    sigma = v @ (w @ u)
    return (weight / torch.clamp_min(sigma, 1e-12)).to(weight.dtype)


class FoldCache(nn.Module):
    """A module whose forward uses tensors derived from its parameters
    (weight norm folded, kernels stacked for a CUDA kernel). `folded(build)`
    runs `build` once and reuses its result until a parameter changes: the
    key is each parameter's storage and in-place write count, which
    load_state_dict and every in-place edit move, and .to() and the other
    conversions drop the cache. `params` narrows the key to the tensors
    `build` reads (default: every parameter)."""

    _folded = None

    def folded(self, build, params=None):
        key = tuple((p.data_ptr(), p._version)
                    for p in (self.parameters() if params is None else params))
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                self._folded = (key, build())
        return self._folded[1]

    def _apply(self, fn, *args, **kwargs):
        self._folded = None
        return super()._apply(fn, *args, **kwargs)


class _ConvBase(FoldCache):
    """A conv kernel with optional weight norm over every axis but the first
    (out channels for Conv1d / Conv2dNorm, in channels for ConvTranspose1d)
    or spectral norm, and a bias."""

    def _make_params(self, shape, out_features: int, bias: bool, weight_norm: bool,
                     kernel_init: str, spectral_norm: bool = False) -> None:
        self.kernel_init = kernel_init
        self.weight_norm = weight_norm and not spectral_norm
        self.spectral_norm = spectral_norm
        if self.weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(shape[0], *([1] * (len(shape) - 1))))
        elif spectral_norm:
            self.v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        p = self.weight if not (self.weight_norm or self.spectral_norm) else self.v
        _fill_kernel(p, self.kernel_init, math.prod(p.shape[1:]), gen)
        if self.weight_norm:
            with torch.no_grad():
                self.g.copy_(_norm_except(self.v, 0))
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def host_kernel(self) -> torch.Tensor:
        """The kernel folded on the host from host copies of the parameters,
        rounded to the compute dtype: what the int8 modes quantize, once, so
        that the card's codes and scales are the CPU's bit for bit (a norm
        summed in another order on the card would move a code at a rounding
        boundary, and a W8A8 decoder carries one moved code on to many)."""
        return self.kernel(host=True).to(self.dtype)

    tp = None  # a Shard under tensor parallelism (parallel/mesh.py)

    def kernel(self, host: bool = False) -> torch.Tensor:
        """The float32 kernel, weight norm or spectral norm folded (from host
        copies of the parameters, without a graph, with `host`); under
        tensor parallelism the whole kernel, gathered from the shards."""
        if self.tp is not None:
            if host:
                raise NotImplementedError("a host copy of a sharded kernel")
            return gather(self.local_kernel(), 0, self.tp)
        return self.local_kernel(host)

    def local_kernel(self, host: bool = False) -> torch.Tensor:
        """This rank's slice of the folded kernel (the whole kernel without
        tensor parallelism): weight norm folds this rank's slice of `g`."""
        get = (lambda p: p.detach().cpu()) if host else (lambda p: p)
        if self.weight_norm:
            v, g = get(self.v), get(self.g)
            if self.tp is not None:
                g = split(g, 0, self.tp)
            return g * v / torch.clamp_min(_norm_except(v, 0), 1e-12)
        if self.spectral_norm:
            return spectral_normalize(get(self.v))
        return get(self.weight)

    def _gathered(self, y: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        """A column-parallel layer's output channels (the last axis) joined,
        then its bias."""
        y = gather(y, -1, self.tp)
        return y if b is None else y + b

    def device(self) -> torch.device:
        return next(self.parameters()).device


def check_quant_int8(quant_int8) -> Union[bool, str]:
    """The int8 decoder mode: False (float), True (dynamic W8A8) or "w8"
    (weight-only), as the JAX package's `quant_int8`."""
    if quant_int8 in (None, False):
        return False
    if quant_int8 is True or quant_int8 == "w8":
        return quant_int8
    raise ValueError(f"quant_int8 must be False, True (W8A8) or \"w8\", got {quant_int8!r}")


@functools.lru_cache(maxsize=None)
def _transpose_placement(kernel_size: int, stride: int, padding: int):
    """Where each tap of a transposed conv lands in its phase-decomposed
    conv (the port's copy of vcvits_tpu/ops/folded_conv.py's placement rule
    at fold_in 1): output frame t * stride + f reads input frame t + m
    through tap u wherever (f + padding - u) % stride == 0, m = (f + padding
    - u) // stride. Returns ((u, f, m), ...), min m, max m."""
    k, s, p = kernel_size, stride, padding
    entries = tuple((u, f, (f + p - u) // s) for f in range(s) for u in range(k)
                    if (f + p - u) % s == 0)
    ms = [m for _, _, m in entries]
    return entries, min(ms), max(ms)


def fold_transpose_kernel(w: torch.Tensor, stride: int, padding: int
                          ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """A ConvTranspose1d kernel [Ci, Co, k] -> the kernel [stride * Co, Ci,
    K'] of the same transposed conv as a stride-1 conv over the input,
    column f * Co + o computing output phase f (frame t * stride + f) of
    channel o, and that conv's (pad_lo, pad_hi). Its output [B, T, stride *
    Co] is the transposed conv's [B, T * stride, Co] after a reshape, where
    kernel_size - 2 * padding == stride."""
    ci, co, k = w.shape
    entries, qmin, qmax = _transpose_placement(k, stride, padding)
    wf = w.new_zeros(stride, co, ci, qmax - qmin + 1)
    for u, f, m in entries:
        wf[f, :, :, m - qmin] = w[:, :, u].t()
    return wf.reshape(stride * co, ci, qmax - qmin + 1), (-qmin, qmax)


class Conv1d(_ConvBase):
    """1-D convolution with PyTorch Conv1d semantics on [B, T, C] tensors.

    Kernel [out, in/groups, k]. `padding` is "same" (symmetric, odd kernels),
    "valid", or an explicit (lo, hi) pair. `weight_norm=True` stores (v, g)
    and folds them per call; `spectral_norm=True` stores `v` and divides it
    by its largest singular value per call (`spectral_normalize`).
    `quant_int8` (the decoder's, inference only): True runs the dynamic W8A8
    conv of ops/int8_conv.py (kernels Q2 and Q1 on the card) on the kernel
    folded in the compute dtype and quantized per output channel, "w8" the
    ordinary conv on that kernel's int8-grid copy; either is folded once
    and cached. `forward(x, act_slope)` applies leaky_relu(act_slope) to x
    first, inside the W8A8 quantizer.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: Union[str, Tuple[int, int]] = "same", bias: bool = True,
                 weight_norm: bool = False, kernel_init: str = "lecun_normal",
                 spectral_norm: bool = False, quant_int8: Union[bool, str] = False,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        if padding == "same":
            self.pad = torch_same_padding(kernel_size, dilation)
        elif padding == "valid":
            self.pad = (0, 0)
        else:
            self.pad = tuple(padding)
        self.quant_int8 = check_quant_int8(quant_int8)
        if self.quant_int8 is True and (stride != 1 or groups != 1):
            raise ValueError("the W8A8 conv takes stride 1 and groups 1")
        self.dtype = dtype
        self._make_params((out_channels, in_channels // groups, kernel_size), out_channels,
                          bias, weight_norm, kernel_init, spectral_norm)

    def compute_kernel(self) -> torch.Tensor:
        """The kernel the float path convolves with, in the compute dtype; in
        "w8" mode its int8-grid copy (cached)."""
        dt = self.dtype
        if self.quant_int8 == "w8":
            return self.folded(lambda: dequantize(
                *quantize_weight_per_channel(self.host_kernel()), dt).to(self.device()))
        return self.kernel().to(dt)

    def w8a8_conv(self) -> W8A8Conv:
        """The W8A8 conv (quant_int8 True): the kernel folded on the host,
        quantized and packed once (cached), with its padding, bias and
        dilation."""
        return W8A8Conv(self.folded(lambda: prepare_w8a8(self.host_kernel()).to(self.device())),
                        self.pad, self.bias, self.dilation)

    def forward(self, x: torch.Tensor, act_slope: Optional[float] = None) -> torch.Tensor:
        dt = self.dtype
        if self.quant_int8 is True:
            c = self.w8a8_conv()
            return int8_conv.conv1d_w8a8(x.to(dt).contiguous(), c.qw, c.pad, c.bias,
                                         c.dilation, act_slope)
        if act_slope is not None:
            x = leaky_relu(x, act_slope)
        b = self.bias.to(dt) if self.bias is not None else None
        xt = x.to(dt).transpose(1, 2)
        if self.pad != (0, 0):
            xt = F.pad(xt, self.pad)
        if self.tp is not None:  # column-parallel: this rank's output channels
            # a grouped conv's whole groups read only their own input channels
            xin = split(xt, 1, self.tp) if self.groups > 1 else copy_to(xt, self.tp)
            y = conv_op(F.conv1d, xin, self.local_kernel().to(dt), None, stride=self.stride,
                        dilation=self.dilation, groups=max(self.groups // self.tp.size, 1))
            return self._gathered(y.transpose(1, 2), b)
        y = conv_op(F.conv1d, xt, self.compute_kernel(), b, stride=self.stride,
                    dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(_ConvBase):
    """Transposed 1-D conv with PyTorch ConvTranspose1d arithmetic.

    out_len = (T-1)*stride - 2*padding + kernel_size. Kernel [in, out, k];
    weight norm is per INPUT channel (PyTorch's weight_norm dim=0 on this
    layout), as in vcvits_tpu/models/layers.py:336-342.
    With `quant_int8` it runs as the JAX package's default (fold_tail) path
    computes it: the phase-decomposed conv of `fold_transpose_kernel`,
    quantized per column, so each (output phase, channel) has its own scale
    (a phase uses only its own taps); W8A8 through ops/int8_conv.py, "w8"
    as an ordinary conv on the dequantized phase kernel; the bias rounded
    to the compute dtype, as that path does. It needs kernel_size - 2 *
    padding == stride (every HiFi-GAN upsampler).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 weight_norm: bool = False, kernel_init: str = "lecun_normal",
                 quant_int8: Union[bool, str] = False, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.quant_int8 = check_quant_int8(quant_int8)
        if self.quant_int8 and kernel_size - 2 * padding != stride:
            raise ValueError("the int8 transposed conv needs kernel_size - 2 * padding == stride")
        self.dtype = dtype
        self._make_params((in_channels, out_channels, kernel_size), out_channels, bias,
                          weight_norm, kernel_init)

    def phase_weights(self):
        """(kernel, (pad_lo, pad_hi), bias) of the int8 phase-decomposed conv,
        cached: a `QWeight` (W8A8) or the dequantized [stride * Co, Ci, K']
        kernel in the compute dtype ("w8"), and the bias tiled per phase in
        float32."""
        dt, s = self.dtype, self.stride

        def build():
            dev = self.device()
            wf, pad = fold_transpose_kernel(self.host_kernel(), s, self.padding)
            b = None if self.bias is None else self.bias.to(dt).float().repeat(s).contiguous()
            if self.quant_int8 is True:
                return prepare_w8a8(wf).to(dev), pad, b
            return dequantize(*quantize_weight_per_channel(wf), dt).to(dev), pad, b
        return self.folded(build)

    def w8a8_conv(self) -> W8A8Conv:
        """The W8A8 phase-decomposed conv (quant_int8 True): its output [B,
        T, stride * Co] is this layer's [B, T * stride, Co] after a reshape."""
        qw, pad, b = self.phase_weights()
        return W8A8Conv(qw, pad, b, 1)

    def forward(self, x: torch.Tensor, act_slope: Optional[float] = None) -> torch.Tensor:
        dt = self.dtype
        if self.quant_int8 is True:
            c = self.w8a8_conv()
            y = int8_conv.conv1d_w8a8(x.to(dt).contiguous(), c.qw, c.pad, c.bias, 1, act_slope)
            return y.reshape(y.shape[0], -1, c.qw.co // self.stride)
        if act_slope is not None:
            x = leaky_relu(x, act_slope)
        if self.quant_int8 == "w8":
            w, pad, b = self.phase_weights()
            xt = F.pad(x.to(dt).transpose(1, 2), pad)
            y = conv_op(F.conv1d, xt, w, None if b is None else b.to(dt)).transpose(1, 2)
            return y.reshape(y.shape[0], -1, w.shape[0] // self.stride)
        b = self.bias.to(dt) if self.bias is not None else None
        if self.tp is not None:  # row-parallel: this rank's input channels
            xt = split(x.to(dt), -1, self.tp).transpose(1, 2)
            y = conv_op(F.conv_transpose1d, xt, self.local_kernel().to(dt), None,
                        stride=self.stride, padding=self.padding)
            y = reduce_from(y, self.tp).transpose(1, 2)
            return y if b is None else y + b
        y = conv_op(F.conv_transpose1d, x.to(dt).transpose(1, 2), self.kernel().to(dt), b,
                    stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class Conv2dNorm(_ConvBase):
    """2-D conv for the period discriminators on [B, H, W, C] (NHWC) tensors,
    the JAX package's layout. Kernel [out, in, kh, kw]; weight norm (the
    default) or spectral norm over every axis but the output channel.
    `padding` is ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
                 weight_norm: bool = True, spectral_norm: bool = False,
                 kernel_init: str = "lecun_normal", dtype=torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.pad = (padding[1][0], padding[1][1], padding[0][0], padding[0][1])  # F.pad order
        self.dtype = dtype
        self._make_params((out_channels, in_channels, *kernel_size), out_channels, True,
                          weight_norm, kernel_init, spectral_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        xt = x.to(dt).permute(0, 3, 1, 2)
        if any(self.pad):
            xt = F.pad(xt, self.pad)
        if self.tp is not None:  # column-parallel: this rank's output channels
            y = conv_op(F.conv2d, copy_to(xt, self.tp), self.local_kernel().to(dt), None,
                        stride=self.strides)
            return self._gathered(y.permute(0, 2, 3, 1), self.bias.to(dt))
        y = conv_op(F.conv2d, xt, self.kernel().to(dt), self.bias.to(dt), stride=self.strides)
        return y.permute(0, 2, 3, 1)


def init_weights(model: nn.Module, seed: int, device=None) -> nn.Module:
    """Seeded initialisation of every parameter, mirroring the JAX package's
    initialisers (lecun/he normal kernels, N(0, 0.01) HiFi-GAN convs, a
    zero flow `post`, weight-norm `g` = ||v||). Each module's
    `reset_parameters` fills its own direct parameters; the draws are made
    in module order on the CPU, or from a generator on `device` (another
    stream of numbers for the same seed, and far faster for a billion
    parameters on the card), and copied to wherever the parameters live."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model
