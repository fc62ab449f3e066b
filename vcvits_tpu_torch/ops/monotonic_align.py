"""Monotonic alignment search (MAS): kernel M1.

Replaces vcvits_tpu/ops/monotonic_align.py:maximum_path, a lax.scan DP
over the spectrogram frames and a backtracking scan (no Pallas kernel).
Per batch row, the path through value[x, y] (text position x, frame y)
that maximises its sum, starting at (0, 0), ending at (T_x - 1, T_y - 1)
of the row's valid region, one x per frame, x stepping by 0 or +1.

* `maximum_path_plain(value, mask)` is JAX's function as PyTorch ops, on
  JAX's arguments (value and mask [B, T_x, T_y]): scores masked to -1e9,
  the strict `diag > stay`, lengths from the mask clamped to >= 1, the
  backtrack's `1 <= y <= y_len - 1` rule and its gather's index rule (an x
  below 0 reads x + T_x, one below -T_x reads True), the one-hot path
  times the mask.
  Every float32 add is JAX's, in its order, so the path is bit-equal.
* `maximum_path(neg_cent, x_lengths, y_lengths)` is the wrapper, on the
  scores in the [B, T_y, T_x] layout in which the synthesizer computes
  them and the rows' lengths (the mask is the outer product of the two
  sequence masks). It returns the path [B, T_x, T_y] in float32. A CPU
  tensor runs the plain version at any size; a CUDA tensor launches
  csrc/monotonic_align.cu once on `plan`'s launch shape (its design and
  bound are in the source's header note) or raises. The card takes T_x up
  to MAX_T_X = 7168, where eight staged score columns of the DP's width
  fill a block's 227 KB of shared memory, and any T_y that keeps a row's
  path and decisions below 2^31 entries and bytes (the decisions go to a
  global scratch where they do not fit in shared memory).
* `plan(t_x, t_y, b, sms)` is that launch shape: R positions a lane and the
  DP warps covering T_x, the ring of score stages, where the decisions
  live, the handoff words, and the blocks a row (the DP's block and the
  blocks that zero the path beside it).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from vcvits_tpu_torch.ops import _build

NEG_INF = -1e9
SMEM_LIMIT = 232448  # the shared memory a Hopper block may use (227 KB)
MAX_DP_WARPS = 15  # with the copy warp, 512 threads
MAX_CLUSTER = 4  # blocks a row: the DP's and up to 3 zeroing the path
# (stages, columns a stage), best first: one DP warp runs best on few chunk
# boundaries; several refill a stage only once the last of them has left
# it, so more stages keep the copies ahead of the first
RINGS = {True: ((2, 32), (2, 16), (2, 8), (2, 4)),
         False: ((4, 16), (3, 16), (2, 16), (4, 8), (2, 8), (2, 4))}
MIN_SHARED_RING = 48  # staged columns below which the decisions go to the global scratch


@dataclass(frozen=True)
class Plan:
    """M1's launch shape (csrc/monotonic_align.cu checks it again)."""
    lanes_r: int  # consecutive x a lane: 8 or 16
    warps: int  # DP warps, each 32 * lanes_r positions of x
    stages: int  # ring stages of staged scores
    cols: int  # score columns a stage
    slots: int  # handoff words a DP warp, a power of two above stages * cols
    shared_bits: bool  # the decisions in shared memory, else in a global scratch
    cluster: int  # blocks a row
    smem: int  # dynamic shared-memory bytes a block

    @property
    def width(self) -> int:
        """The positions of x the DP warps cover (the ring's column)."""
        return self.warps * 32 * self.lanes_r

    @property
    def words(self) -> int:
        """32-bit decision words a column."""
        return self.warps * self.lanes_r


def smem_bytes(t_y: int, lanes_r: int, warps: int, stages: int, cols: int, slots: int,
               shared_bits: bool) -> int:
    """The kernel's shared memory (csrc/monotonic_align.cu:layout): the
    ring, the decisions if shared (rounded to 16 bytes), the handoff words,
    two mbarriers a stage."""
    ring = stages * cols * warps * 32 * lanes_r * 4
    bits = -(-t_y * warps * lanes_r * 4 // 16) * 16 if shared_bits else 0
    return ring + bits + (warps - 1) * slots * 8 + 2 * stages * 8


def lanes_for(t_x: int) -> int:
    """R: 8 while MAX_DP_WARPS warps of 8 cover T_x (3840), then 16."""
    return 8 if t_x <= MAX_DP_WARPS * 32 * 8 else 16


def plan(t_x: int, t_y: int, b: int, sms: int = 132, lanes_r: Optional[int] = None
         ) -> Optional[Plan]:
    """The launch shape for [b, t_y, t_x] scores on a card of `sms` SMs, or
    None where no ring fits shared memory (T_x above MAX_T_X) or a row's
    path has 2^31 entries or its decisions 2^31 bytes. The
    decisions stay in shared memory where a ring of at least
    MIN_SHARED_RING columns still fits beside them; a row takes a cluster
    of up to MAX_CLUSTER blocks while b rows leave SMs free. `lanes_r`
    sets R in place of lanes_for's (for comparing launch shapes)."""
    r = lanes_r or lanes_for(t_x)
    warps = -(-t_x // (32 * r))
    # a row's path and decisions are indexed in 32 bits
    if warps > MAX_DP_WARPS or t_x * t_y >= 1 << 31 or t_y * warps * r * 4 >= 1 << 31:
        return None
    cluster = max(1, min(MAX_CLUSTER, sms // max(b, 1)))
    for shared in (True, False):
        for stages, cols in RINGS[warps == 1]:
            if shared and stages * cols < MIN_SHARED_RING:
                continue
            slots = 1 << (stages * cols).bit_length()  # the power of two above
            smem = smem_bytes(t_y, r, warps, stages, cols, slots, shared)
            if smem <= SMEM_LIMIT:
                return Plan(r, warps, stages, cols, slots, shared, cluster, smem)
    return None


def max_t_x() -> int:
    """The largest T_x any T_y takes (the decisions of a long T_y go to the
    global scratch, so T_y does not matter)."""
    lo, hi = 1, 32 * 16 * MAX_DP_WARPS
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if plan(mid, 1, 1) is not None else (lo, mid - 1)
    return lo


MAX_T_X = 7168  # max_t_x(): 8 staged columns x 7168 floats, 224 KB


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
        # JAX's gather: an index below 0 counts from the end, one below -t_x
        # reads the fill value True (only scores summing under -1e9 get there)
        idx = torch.where(x < 0, x + t_x, x)
        fd = torch.where(idx >= 0, from_diag[y][rows, idx.clamp_min(0)], True)
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("monotonic_align")
    if not getattr(lib, "_vc_typed", False):
        lib.monotonic_align.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        lib.monotonic_align.restype = ctypes.c_int
        lib.monotonic_align_smem.argtypes = [ctypes.c_int] * 8
        lib.monotonic_align_smem.restype = ctypes.c_longlong
        lib._vc_typed = True
    return lib


def kernel_smem(t_y: int, t_x: int, shape: Plan) -> int:
    """The built library's shared-memory bytes for `shape` (-1 where it
    refuses the plan), for holding `smem_bytes` to the C side on the card."""
    return int(_lib().monotonic_align_smem(t_y, t_x, shape.lanes_r, shape.warps, shape.stages,
                                           shape.cols, shape.slots, int(shape.shared_bits)))


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def launch(neg_cent: torch.Tensor, x_lengths: torch.Tensor, y_lengths: torch.Tensor,
           shape: Optional[Plan] = None) -> torch.Tensor:
    """One launch on contiguous, 16-byte aligned CUDA float32 neg_cent
    [B, T_y, T_x] and int32 lengths [B] -> path [B, T_x, T_y] float32, on
    `shape` (default: plan's)."""
    b, t_y, t_x = neg_cent.shape
    p = shape or plan(t_x, t_y, b, _sms(neg_cent.device))
    if p is None:
        raise ValueError(f"maximum_path: the kernel takes T_x up to {MAX_T_X} and T_x * T_y "
                         f"below 2^31, got {t_x} x {t_y}")
    lib = _lib()
    path = torch.empty(b, t_x, t_y, dtype=torch.float32, device=neg_cent.device)
    bits = None if p.shared_bits else torch.empty(b, t_y, p.words, dtype=torch.int32,
                                                  device=neg_cent.device)
    with _build.device_guard(neg_cent.device):
        err = lib.monotonic_align(neg_cent.data_ptr(), x_lengths.data_ptr(),
                                  y_lengths.data_ptr(), path.data_ptr(),
                                  None if bits is None else bits.data_ptr(), b, t_y, t_x,
                                  p.lanes_r, p.warps, p.stages, p.cols, p.cluster, p.slots,
                                  int(p.shared_bits), _build.current_stream(neg_cent.device))
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
    if t_x > MAX_T_X:
        raise ValueError(f"maximum_path: the kernel takes T_x up to {MAX_T_X} (shared "
                         f"memory), got {t_x}")
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path: unsupported device {neg_cent.device}")
    if x_lengths.device != neg_cent.device or y_lengths.device != neg_cent.device:
        raise ValueError("maximum_path: the lengths must be on neg_cent's device")
    if neg_cent.requires_grad:
        raise ValueError("maximum_path: the kernel has no backward (the path is a constant)")
    return launch(_build.aligned16(neg_cent.contiguous()), x_lengths.to(torch.int32).contiguous(),
                  y_lengths.to(torch.int32).contiguous())
