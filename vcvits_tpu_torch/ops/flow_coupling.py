"""The WaveNet stack of a residual coupling: kernel K2, in three modes.

Replaces vcvits_tpu/ops/flow_pallas.py:_coupling_reverse / _coupling_kernel.
Every mode runs the same WaveNet layers, for l in the launch's layers:

    acc  = b_in[l] + cond[l] + conv_K(h, W_in[l])
    a    = tanh(acc[:H]) * sigmoid(acc[H:])
    rs   = a . W_rs[l] + b_rs[l];  h = (h + rs[:H]) * mask;  skip += rs[H:]

* `coupling_reverse` (the inference reverse) and `coupling_forward` (the
  flow forward of `voice_conversion`): one mean-only coupling of
  x = [x0, x1], h = (x0 . W_pre + b_pre) * mask and skip = 0 in,
  m = ((skip * mask) . W_post + b_post) * mask out, and
  out = [x0, (x1 - m) * mask] (reverse) or [x0, (m + x1) * mask] (forward).
* `wn_segment`: up to `WN_SEGMENT_LAYERS` consecutive layers of a longer
  WaveNet, (h, skip) in and out, no pre or post; the posterior's 16-layer
  WN is four of them.

All in float32, the outputs in the input's dtype (`wn_segment`: float32).
The weights come folded (weight norm applied, a WaveNet's last res_skip
packed into the skip half) as (w_pre [half, H], b_pre [H], w_in [L, K, H, 2H],
b_in [L, 2H], w_rs [L, H, 2H], b_rs [L, 2H], w_post [H, half], b_post [half]),
`wn_segment` taking the middle four. The speaker conditioning `cond`
[B, L*2H] (or None), the channel flip between couplings and a WaveNet's
final skip * mask are the caller's, as in the JAX package.

On a CPU tensor each mode runs its plain version (`*_plain`, PyTorch ops);
on a CUDA tensor it launches csrc/flow_coupling.cu once or raises (a size
`plan` refuses, or a tensor that requires grad: the kernel has no
backward). The kernel's design and bound are in the source's header note.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

Weights = Tuple[torch.Tensor, ...]

REVERSE, FORWARD, WN_SEGMENT = 0, 1, 2
KERNEL_NAMES = {REVERSE: "flow_coupling_reverse", FORWARD: "flow_coupling_forward",
                WN_SEGMENT: "wn_segment"}
WN_SEGMENT_LAYERS = 4  # layers a wn_segment launch: the coupling's halo of 8 at K = 5

# csrc/flow_coupling.cu's tiling: 80-row tiles (centre + 2 halo); a cluster
# of H / P CTAs, P = 16 hidden channels a CTA up to H = 128, else 32; the h
# and gate copies blocked by owner, rows of P + 4 floats; the weights
# through a 2-deep ring of [KC x (2P + 8)] fp32 tiles;
# the CTA's biases of every layer, the mask and two 8-byte mbarriers.
ROWS = 80
STAGES = 2
SCRATCH_BYTES = 8 * (ROWS // 16) * 2 * 4 * 32 * 4  # every warp's split-K partial sums
MAX_SMEM = 232448  # bytes of shared memory a block can have on an H100


class Plan(NamedTuple):
    """One launch: `cluster` CTAs a tile of `tile` centre frames and `halo`
    frames each side, `pairs` hidden channels a CTA, weight tiles of `kc`
    input channels, `smem` dynamic shared-memory bytes a CTA."""
    cluster: int
    pairs: int
    tile: int
    halo: int
    kc: int
    smem: int


def _round128(v: int) -> int:
    return -(-v // 128) * 128


@functools.lru_cache(maxsize=None)
def plan(hidden: int, k: int, n_layers: int, half: Optional[int] = None) -> Plan:
    """The launch shape of csrc/flow_coupling.cu:make_plan for hidden width,
    kernel size, layers and, for the coupling modes, `half` channels
    (None for `wn_segment`); ValueError where the kernel does not take it."""
    if hidden % 64 or not 64 <= hidden <= 256:
        raise ValueError(f"flow kernel: hidden must be a multiple of 64 from 64 to 256, "
                         f"got {hidden}")
    if k < 1 or k % 2 == 0 or n_layers < 1:
        raise ValueError(f"flow kernel: needs an odd kernel and a layer, got K={k}, "
                         f"layers={n_layers}")
    if half is not None and (half < 4 or half % 4 or half > hidden):
        raise ValueError(f"flow kernel: half channels must be a multiple of 4 up to hidden "
                         f"{hidden}, got {half}")
    pairs = 16 if hidden <= 128 else 32
    kc = min(hidden, 128) if pairs == 16 else 64
    halo = n_layers * ((k - 1) // 2)
    tile = ROWS - 2 * halo
    if tile < 16:
        raise ValueError(f"flow kernel: {n_layers} layers of K={k} leave {tile} of {ROWS} "
                         f"rows a tile")
    n, pb = hidden // pairs, pairs + 4
    smem = (_round128(max(n * (ROWS + k - 1) * pb * 4, SCRATCH_BYTES))
            + _round128(max(n * ROWS * pb * 4, SCRATCH_BYTES))
            + STAGES * kc * (2 * pairs + 8) * 4 + 16 * n_layers * pairs
            + ROWS * 4 + 16)
    if smem > MAX_SMEM:
        raise ValueError(f"flow kernel: hidden={hidden}, K={k} needs {smem} bytes of shared "
                         f"memory a block, above {MAX_SMEM}")
    return Plan(hidden // pairs, pairs, tile, halo, kc, smem)


def _wn_plain(h: torch.Tensor, skip: torch.Tensor, m: torch.Tensor,
              cond: Optional[torch.Tensor], w_in: torch.Tensor, b_in: torch.Tensor,
              w_rs: torch.Tensor, b_rs: torch.Tensor):
    hidden = w_in.shape[2]
    k = w_in.shape[1]
    for layer in range(w_in.shape[0]):
        acc = F.conv1d(h.transpose(1, 2), w_in[layer].permute(2, 1, 0),
                       padding=(k - 1) // 2).transpose(1, 2) + b_in[layer]
        if cond is not None:
            acc = acc + cond[:, None, layer * 2 * hidden:(layer + 1) * 2 * hidden]
        a = torch.tanh(acc[..., :hidden]) * torch.sigmoid(acc[..., hidden:])
        rs = a @ w_rs[layer] + b_rs[layer]
        h = (h + rs[..., :hidden]) * m
        skip = skip + rs[..., hidden:]
    return h, skip


def _coupling_plain(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                    weights: Weights, mode: int) -> torch.Tensor:
    w_pre, b_pre, w_in, b_in, w_rs, b_rs, w_post, b_post = weights
    xf, m = x.float(), mask.float()
    half = xf.shape[-1] // 2
    x0, x1 = xf[..., :half], xf[..., half:]
    h = (x0 @ w_pre + b_pre) * m
    _, skip = _wn_plain(h, torch.zeros_like(h), m, cond, w_in, b_in, w_rs, b_rs)
    stats = ((skip * m) @ w_post + b_post) * m
    x1 = (x1 - stats) * m if mode == REVERSE else (stats + x1) * m
    return torch.cat([x0, x1], dim=-1).to(x.dtype)


def coupling_reverse_plain(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                           weights: Weights) -> torch.Tensor:
    """The coupling reverse in PyTorch ops, float32 throughout."""
    return _coupling_plain(x, mask, cond, weights, REVERSE)


def coupling_forward_plain(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                           weights: Weights) -> torch.Tensor:
    """The coupling forward in PyTorch ops, float32 throughout."""
    return _coupling_plain(x, mask, cond, weights, FORWARD)


def wn_segment_plain(h: torch.Tensor, skip: torch.Tensor, mask: torch.Tensor,
                     cond: Optional[torch.Tensor], weights: Weights
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WaveNet layers on (h, skip) in PyTorch ops -> float32 (h, skip)."""
    return _wn_plain(h.float(), skip.float(), mask.float(), cond, *weights)


def _lib():
    lib = _build.load("flow_coupling")
    if not getattr(lib, "_vc_typed", False):
        lib.flow_wn_stack.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.flow_wn_stack.restype = ctypes.c_int
        lib.flow_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.flow_plan.restype = ctypes.c_int
        lib._vc_typed = True
    return lib


def kernel_plan(hidden: int, k: int, n_layers: int, half: Optional[int] = None
                ) -> Tuple[int, int, int]:
    """(cluster, tile, smem) as the built library's flow_plan gives them, for
    holding `plan` to the C side on the card; ValueError where it refuses."""
    out = [ctypes.c_int() for _ in range(3)]
    mode = WN_SEGMENT if half is None else REVERSE
    err = _lib().flow_plan(hidden, k, n_layers, half or 0, mode,
                           *(ctypes.byref(v) for v in out))
    if err:
        raise ValueError(f"flow_plan refuses hidden={hidden}, K={k}, layers={n_layers}, "
                         f"half={half}")
    return tuple(v.value for v in out)


def _check(name: str, x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
           weights: Weights, shapes, n_layers: int, hidden: int) -> None:
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: input must be float32/bfloat16 [B, T, C], "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, _ = x.shape
    if tuple(mask.shape) != (b, t, 1) or mask.device != x.device:
        raise ValueError(f"{name}: mask must be [B, T, 1] on {x.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    for i, (wt, shape) in enumerate(zip(weights, shapes)):
        if tuple(wt.shape) != shape or wt.dtype != torch.float32 or wt.device != x.device \
                or not wt.is_contiguous():
            raise ValueError(f"{name}: weight {i} must be a contiguous float32 {shape} tensor "
                             f"on {x.device}, got {wt.dtype} {tuple(wt.shape)} on {wt.device}")
    if cond is not None and (tuple(cond.shape) != (b, n_layers * 2 * hidden)
                             or cond.dtype != torch.float32 or cond.device != x.device
                             or not cond.is_contiguous()):
        raise ValueError(f"{name}: cond must be contiguous float32 [B, {n_layers * 2 * hidden}] "
                         f"on {x.device}, got {cond.dtype} {tuple(cond.shape)}")
    if any(v is not None and v.requires_grad for v in (x, mask, cond, *weights)):
        raise ValueError(f"{name}: the kernel has no backward; pass tensors that do not "
                         f"require grad (torch.no_grad())")


def _wn_shapes(n_layers: int, k: int, hidden: int):
    return ((n_layers, k, hidden, 2 * hidden), (n_layers, 2 * hidden),
            (n_layers, hidden, 2 * hidden), (n_layers, 2 * hidden))


def _launch(mode: int, x: torch.Tensor, skip: Optional[torch.Tensor], mask: torch.Tensor,
            cond: Optional[torch.Tensor], weights: Weights, half: int):
    """One launch on CUDA tensors that `_check` passed; returns out (and
    skip_out for WN_SEGMENT), float32."""
    name = KERNEL_NAMES[mode]
    coupling = mode != WN_SEGMENT
    w_in = weights[2] if coupling else weights[0]
    n_layers, k, hidden = w_in.shape[0], w_in.shape[1], w_in.shape[2]
    plan(hidden, k, n_layers, half if coupling else None)
    b, t, _ = x.shape
    with _build.device_guard(x.device):
        xf = _build.aligned16(x.float().contiguous())
        mf = _build.aligned16(mask.float().reshape(b, t).contiguous())
        ws = [_build.aligned16(w) for w in weights]
        cd = None if cond is None else _build.aligned16(cond)
        out = torch.empty_like(xf)
        if coupling:
            w_pre, b_pre, w_in, b_in, w_rs, b_rs, w_post, b_post = ws
            sk_in = sk_out = None
        else:
            w_in, b_in, w_rs, b_rs = ws
            w_pre = b_pre = w_post = b_post = None
            sk_in = _build.aligned16(skip.float().contiguous())
            sk_out = torch.empty_like(sk_in)
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        err = _lib().flow_wn_stack(
            mode, xf.data_ptr(), ptr(sk_in), mf.data_ptr(), ptr(cd), ptr(w_pre), ptr(b_pre),
            w_in.data_ptr(), b_in.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(), ptr(w_post),
            ptr(b_post), out.data_ptr(), ptr(sk_out), b, t, half if coupling else 0, hidden,
            n_layers, k, _build.current_stream(x.device))
    _build.check(err, name)
    _build.count(name)
    return out if coupling else (out, sk_out)


def _coupling(mode: int, x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
              weights: Weights) -> torch.Tensor:
    name = KERNEL_NAMES[mode]
    if x.device.type == "cpu":
        return _coupling_plain(x, mask, cond, weights, mode)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if len(weights) != 8 or x.dim() != 3:
        raise ValueError(f"{name}: expects x [B, T, C] and 8 folded weights")
    half, hidden = x.shape[-1] // 2, weights[0].shape[1]
    n_layers, k = weights[2].shape[0], weights[2].shape[1]
    _check(name, x, mask, cond, weights,
           ((half, hidden), (hidden,), *_wn_shapes(n_layers, k, hidden), (hidden, half),
            (half,)), n_layers, hidden)
    return _launch(mode, x, None, mask, cond, weights, half).to(x.dtype)


def coupling_reverse(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                     weights: Weights) -> torch.Tensor:
    """x [B, T, C], mask [B, T, 1], cond [B, L*2H] or None -> x' [B, T, C]."""
    return _coupling(REVERSE, x, mask, cond, weights)


def coupling_forward(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                     weights: Weights) -> torch.Tensor:
    """x [B, T, C], mask [B, T, 1], cond [B, L*2H] or None -> x' [B, T, C]."""
    return _coupling(FORWARD, x, mask, cond, weights)


def wn_segment(h: torch.Tensor, skip: torch.Tensor, mask: torch.Tensor,
               cond: Optional[torch.Tensor], weights: Weights
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h, skip [B, T, H], mask [B, T, 1], cond [B, L*2H] or None, weights
    (w_in, b_in, w_rs, b_rs) of L layers -> float32 (h, skip)."""
    if h.device.type == "cpu":
        return wn_segment_plain(h, skip, mask, cond, weights)
    if h.device.type != "cuda":
        raise ValueError(f"wn_segment: unsupported device {h.device}")
    if len(weights) != 4 or h.dim() != 3:
        raise ValueError("wn_segment: expects h [B, T, H] and 4 folded weights")
    n_layers, k, hidden = weights[0].shape[:3]
    _check("wn_segment", h, mask, cond, weights, _wn_shapes(n_layers, k, hidden), n_layers,
           hidden)
    if tuple(skip.shape) != tuple(h.shape) or skip.device != h.device or h.shape[2] != hidden \
            or skip.requires_grad:
        raise ValueError(f"wn_segment: h and skip must be [B, T, {hidden}] on one device, got "
                         f"{tuple(h.shape)} and {tuple(skip.shape)}")
    if n_layers > WN_SEGMENT_LAYERS:
        raise ValueError(f"wn_segment: at most {WN_SEGMENT_LAYERS} layers a launch, got "
                         f"{n_layers}")
    return _launch(WN_SEGMENT, h, skip, mask, cond, weights, 0)
