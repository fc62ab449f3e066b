"""One mean-only residual-coupling reverse pass: kernel K2.

Replaces vcvits_tpu/ops/flow_pallas.py:_coupling_reverse / _coupling_kernel.
For x = [x0, x1] (halves of the channel axis):

    h    = (x0 . W_pre + b_pre) * mask
    per WN layer l: acc = b_in[l] + cond[l] + conv_K(h, W_in[l])
                    a = tanh(acc[:H]) * sigmoid(acc[H:])
                    rs = a . W_rs[l] + b_rs[l];  h = (h + rs[:H]) * mask;  skip += rs[H:]
    m    = ((skip * mask) . W_post + b_post) * mask
    out  = [x0, (x1 - m) * mask]

in float32, the output in x's dtype. The weights come folded (weight norm
applied, the last layer's res_skip packed into the skip half) as
(w_pre [half, H], b_pre [H], w_in [L, K, H, 2H], b_in [L, 2H],
w_rs [L, H, 2H], b_rs [L, 2H], w_post [H, half], b_post [half]); the speaker
conditioning `cond` [B, L*2H] (or None) and the channel flip between
couplings are computed by the caller, as in the JAX package.

`coupling_reverse` is the wrapper: a CPU tensor goes to
`coupling_reverse_plain`; a CUDA tensor launches csrc/flow_coupling.cu
(one launch per coupling) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops import _build

Weights = Tuple[torch.Tensor, ...]

# tiles (centre frames per block) the kernel is built for, at halo 8
_TILES = (8, 16, 32)


def coupling_reverse_plain(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                           weights: Weights) -> torch.Tensor:
    """The coupling reverse in PyTorch ops, float32 throughout."""
    w_pre, b_pre, w_in, b_in, w_rs, b_rs, w_post, b_post = weights
    xf, m = x.float(), mask.float()
    half = xf.shape[-1] // 2
    hidden = w_pre.shape[1]
    x0, x1 = xf[..., :half], xf[..., half:]
    h = (x0 @ w_pre + b_pre) * m
    skip = torch.zeros_like(h)
    for layer in range(w_in.shape[0]):
        k = w_in.shape[1]
        acc = F.conv1d(h.transpose(1, 2), w_in[layer].permute(2, 1, 0),
                       padding=(k - 1) // 2).transpose(1, 2) + b_in[layer]
        if cond is not None:
            acc = acc + cond[:, None, layer * 2 * hidden:(layer + 1) * 2 * hidden]
        a = torch.tanh(acc[..., :hidden]) * torch.sigmoid(acc[..., hidden:])
        rs = a @ w_rs[layer] + b_rs[layer]
        h = (h + rs[..., :hidden]) * m
        skip = skip + rs[..., hidden:]
    stats = ((skip * m) @ w_post + b_post) * m
    return torch.cat([x0, (x1 - stats) * m], dim=-1).to(x.dtype)


def pick_tile(batch: int, t: int, sms: int) -> int:
    """Largest tile that still gives each of the card's `sms` SMs a block,
    else the smallest: a tile recomputes 2*8 halo frames, so small tiles
    cost arithmetic and large ones leave SMs idle at batch 1."""
    for tile in reversed(_TILES):
        if batch * -(-t // tile) >= sms:
            return tile
    return _TILES[0]


def _lib():
    lib = _build.load("flow_coupling")
    if not getattr(lib, "_vc_typed", False):
        lib.flow_coupling_reverse.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.flow_coupling_reverse.restype = ctypes.c_int
        lib._vc_typed = True
    return lib


def _check(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
           weights: Weights, tile: int) -> None:
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"coupling_reverse: x must be float32/bfloat16 [B, T, C], "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, c = x.shape
    if tuple(mask.shape) != (b, t, 1):
        raise ValueError(f"coupling_reverse: mask must be [B, T, 1], got {tuple(mask.shape)}")
    w_pre, b_pre, w_in, b_in, w_rs, b_rs, w_post, b_post = weights
    half, hidden = c // 2, w_pre.shape[1]
    n_layers, k = w_in.shape[0], w_in.shape[1]
    shapes = ((half, hidden), (hidden,), (n_layers, k, hidden, 2 * hidden),
              (n_layers, 2 * hidden), (n_layers, hidden, 2 * hidden), (n_layers, 2 * hidden),
              (hidden, half), (half,))
    for i, (wt, shape) in enumerate(zip(weights, shapes)):
        if tuple(wt.shape) != shape or wt.dtype != torch.float32 or wt.device != x.device \
                or not wt.is_contiguous():
            raise ValueError(f"coupling_reverse: weight {i} must be a contiguous float32 "
                             f"{shape} tensor on {x.device}, got {wt.dtype} "
                             f"{tuple(wt.shape)} on {wt.device}")
    if cond is not None and (tuple(cond.shape) != (b, n_layers * 2 * hidden)
                             or cond.dtype != torch.float32 or not cond.is_contiguous()):
        raise ValueError(f"coupling_reverse: cond must be contiguous float32 "
                         f"[B, {n_layers * 2 * hidden}], got {cond.dtype} {tuple(cond.shape)}")
    if 4 * hidden > 512 or hidden % 8 or k % 2 == 0 \
            or tile + 2 * n_layers * ((k - 1) // 2) not in (24, 32, 48):
        raise ValueError(f"coupling_reverse: no kernel build for hidden={hidden}, K={k}, "
                         f"layers={n_layers}, tile={tile}")


def coupling_reverse(x: torch.Tensor, mask: torch.Tensor, cond: Optional[torch.Tensor],
                     weights: Weights, tile: Optional[int] = None) -> torch.Tensor:
    """x [B, T, C], mask [B, T, 1], cond [B, L*2H] or None -> x' [B, T, C]."""
    if x.device.type == "cpu":
        return coupling_reverse_plain(x, mask, cond, weights)
    if x.device.type != "cuda":
        raise ValueError(f"coupling_reverse: unsupported device {x.device}")
    b, t, c = x.shape
    if tile is None:
        tile = pick_tile(b, t, torch.cuda.get_device_properties(x.device).multi_processor_count)
    _check(x, mask, cond, weights, tile)
    w_pre, w_in = weights[0], weights[2]
    lib = _lib()
    with torch.cuda.device(x.device):
        xf = x.float().contiguous()
        mf = mask.float().reshape(b, t).contiguous()
        out = torch.empty_like(xf)
        err = lib.flow_coupling_reverse(
            xf.data_ptr(), mf.data_ptr(), cond.data_ptr() if cond is not None else None,
            *(wt.data_ptr() for wt in weights), out.data_ptr(),
            b, t, c // 2, w_pre.shape[1], w_in.shape[0], w_in.shape[1], tile,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "flow_coupling_reverse")
        _build.LAUNCHES["flow_coupling_reverse"] += 1
        return out.to(x.dtype)
