"""M1's host side on the CPU: the launch plan, the plain version above the
first kernel's T_x cap, and a NumPy model of the kernel's schedule.

* `plan` covers every x exactly once (R positions a lane, warps of 32 R,
  no warp past T_x) and fits the 227 KB of shared memory a block may use,
  for every T_x from 1 to MAX_T_X and T_y up to 2600; no plan exists above
  MAX_T_X, and the wrapper refuses a non-CPU tensor there.
* `maximum_path_plain` equals JAX's `maximum_path` bit for bit at T_x above
  2048 (2 x 2500 x 40) and where scores summing under -1e9 take the
  backtrack's x below 0 and below -T_x (JAX's gather: x + T_x, then True);
  the wrapper's CPU path returns it and launches nothing.
* `kernel_model` repeats csrc/monotonic_align.cu's arithmetic in NumPy:
  the DP over the plan's full width (scores -1e9 past xl), the decisions
  packed into x-linear 32-bit words, and the backtrack from 32-bit windows
  of those words, 16 columns a window, each window's base 31 below the x
  at the start of the window before, with the wrapped windows near x = 0,
  two columns a step.
  Its path equals the plain version's, every entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.ops.monotonic_align import maximum_path as jax_maximum_path
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops import monotonic_align as ma

NEG = np.float32(-1e9)
WINDOW = 16


@pytest.mark.parametrize("t_y", [1, 750, 2600])
def test_plan_covers_each_x_once_and_fits(t_y):
    for t_x in range(1, ma.MAX_T_X + 1):
        p = ma.plan(t_x, t_y, 16)
        assert p is not None, t_x
        r = p.lanes_r
        assert r in (8, 16) and 1 <= p.warps <= ma.MAX_DP_WARPS
        assert (p.warps - 1) * 32 * r < t_x <= p.width == p.warps * 32 * r
        assert p.stages >= 2 and p.cols >= 1
        assert p.slots > p.stages * p.cols and p.slots & (p.slots - 1) == 0
        assert p.smem == ma.smem_bytes(t_y, r, p.warps, p.stages, p.cols, p.slots,
                                       p.shared_bits) <= ma.SMEM_LIMIT
        if p.shared_bits:
            assert p.stages * p.cols >= ma.MIN_SHARED_RING
    assert ma.plan(ma.MAX_T_X + 1, t_y, 16) is None
    assert ma.plan(1000, (1 << 31) // 1000, 1) is not None
    assert ma.plan(1000, (1 << 31) // 1000 + 1, 1) is None  # a row's path past 2^31 entries


def test_plan_limit_is_shared_memory():
    """MAX_T_X is where eight staged columns fill shared memory: the DP
    warps could cover more x (15 warps of 512)."""
    assert ma.max_t_x() == ma.MAX_T_X
    p = ma.plan(ma.MAX_T_X, 1, 1)
    assert p.stages * p.cols == 8 and not p.shared_bits
    assert p.smem + 8 * 4 * 32 * p.lanes_r > ma.SMEM_LIMIT  # one more warp's columns do not fit
    assert ma.MAX_T_X < ma.MAX_DP_WARPS * 32 * 16


@pytest.mark.parametrize("b", [1, 4, 16, 33, 66, 67, 300])
def test_plan_cluster_leaves_no_row_waiting(b):
    """A row takes up to MAX_CLUSTER blocks only while all rows' clusters
    fit the card's SMs at once."""
    p = ma.plan(192, 750, b, sms=132)
    assert 1 <= p.cluster <= ma.MAX_CLUSTER
    assert p.cluster == 1 or p.cluster * b <= 132


def test_wrapper_refuses_above_the_limit():
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="T_x up to 7168"):
        ma.maximum_path(torch.zeros(1, 10, ma.MAX_T_X + 1, device="meta"), one, one)
    with pytest.raises(ValueError, match="unsupported device"):
        ma.maximum_path(torch.zeros(1, 10, ma.MAX_T_X, device="meta"), one, one)


def _jax_path(value, xl, yl):
    t_y, t_x = value.shape[1:]
    mask = np.asarray(ma.length_mask(torch.tensor(xl), torch.tensor(yl), t_x, t_y))
    return np.asarray(jax_maximum_path(jnp.swapaxes(value, 1, 2), mask)), mask


def test_plain_is_jax_above_the_old_cap():
    rng = np.random.default_rng(21)
    value = (rng.standard_normal((2, 40, 2500)) * 30).astype(np.float32)
    xl, yl = [2500, 2100], [40, 33]
    want, mask = _jax_path(value, xl, yl)
    got = ma.maximum_path_plain(torch.from_numpy(value).transpose(1, 2), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    n0 = _build.LAUNCHES["monotonic_align"]
    wrapped = ma.maximum_path(torch.from_numpy(value), torch.tensor(xl), torch.tensor(yl))
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert _build.LAUNCHES["monotonic_align"] == n0


def _below_zero(rng, shape):
    """Scores whose sums fall under -1e9 (every x of row 0, x = 0 of row 1,
    x < 3 of row 2), so the backtrack may step past x = 0."""
    v = (rng.standard_normal(shape) * 30).astype(np.float32)
    v[0] = -2e9
    v[1, :, 0] = -3e9
    v[2, :, :3] = -5e8
    return v


CASES = {
    "ragged": (lambda r, s: (r.standard_normal(s) * 30).astype(np.float32),
               (4, 90, 19), [19, 11, 1, 25], [90, 34, 5, 13]),
    "ties": (lambda r, s: np.round(r.standard_normal(s)).astype(np.float32),
             (4, 90, 19), [19, 19, 7, 3], [90, 41, 90, 3]),
    "x above y": (lambda r, s: (r.standard_normal(s) * 30).astype(np.float32),
                  (3, 20, 70), [70, 40, 21], [20, 12, 20]),
    "empty rows": (lambda r, s: (r.standard_normal(s) * 50).astype(np.float32),
                   (4, 60, 19), [0, 19, 4, 19], [30, 0, 60, 60]),
    "x 1": (lambda r, s: (r.standard_normal(s) * 30).astype(np.float32),
            (2, 37, 1), [1, 1], [37, 1]),
    "two warps": (lambda r, s: (r.standard_normal(s) * 30).astype(np.float32),
                  (2, 300, 290), [290, 201], [300, 260]),
    "below zero": (_below_zero, (3, 40, 7), [7, 7, 6], [40, 40, 33]),
    "below zero, wide": (_below_zero, (3, 90, 45), [45, 45, 30], [90, 80, 90]),
}


def _bits_from(col, base, words):
    i = base >> 5
    lo, hi = int(col[i]), int(col[min(i + 1, words - 1)])
    return ((hi << 32 | lo) >> (base & 31)) & 0xFFFFFFFF


def _window32(col, base, words, t_x):
    """csrc/monotonic_align.cu:window32."""
    if base >= 0:
        return _bits_from(col, base, words)
    if base >= -31:
        w0 = int(col[0])
        s = t_x + base
        wrapped = _bits_from(col, s, words) if s >= 0 else (w0 << -s) | ((1 << -s) - 1)
        return ((w0 << -base) | (wrapped & ((1 << -base) - 1))) & 0xFFFFFFFF
    w = 0
    for i in range(32):
        x = base + i + t_x
        w |= ((int(col[x >> 5]) >> (x & 31)) & 1 if x >= 0 else 1) << i
    return w


def kernel_model(value, xl, yl, p):
    """The kernel's arithmetic on value [B, T_y, T_x] under plan p."""
    b, t_y, t_x = value.shape
    path = np.zeros((b, t_x, t_y), np.float32)
    for row in range(b):
        xr, yr = min(max(xl[row], 0), t_x), min(max(yl[row], 0), t_y)
        if xr == 0 or yr == 0:
            continue
        ring = np.full((t_y, p.width), NEG, np.float32)  # [xl, width) never copied
        ring[:, :xr] = value[row, :, :xr]
        best = np.full(p.width, NEG, np.float32)
        best[0] = ring[0, 0]
        words = np.zeros((t_y, p.words), np.uint32)
        for y in range(1, yr):
            diag = np.concatenate([[NEG], best[:-1]]).astype(np.float32)
            fd = diag > best
            best = np.where(fd, diag, best) + ring[y]
            words[y] = np.packbits(fd, bitorder="little").view("<u4")  # bit x % 32 of word x // 32
        x = xr - 1
        ytop, base = yr - 1, x - 31
        cur = [_window32(words[ytop - j], base, p.words, t_x) if ytop - j >= 1 else 0
               for j in range(WINDOW)]
        while ytop >= 0:
            next_base = x - 31
            nxt = [_window32(words[ytop - WINDOW - j], next_base, p.words, t_x)
                   if ytop - WINDOW - j >= 1 else 0 for j in range(WINDOW)]
            off, falls = x - base, 0
            for j in range(0, WINDOW, 2):  # two columns a step, as the kernel
                assert 0 <= off <= 31
                b1 = (cur[j] >> off) & 1
                c0, c1 = (cur[j + 1] >> off) & 1, ((cur[j + 1] << 1 & 0xFFFFFFFF) >> off) & 1
                c = c0 ^ ((c0 ^ c1) & b1)
                falls |= b1 << j | c << (j + 1)
                off -= b1 + c
            for j in range(WINDOW):  # lane j: x less the falls before column j
                y, xx = ytop - j, x - bin(falls & ((1 << j) - 1)).count("1")
                if y >= 0 and xx >= 0:
                    path[row, xx, y] = 1.0
            x, base, cur = base + off, next_base, nxt
            ytop -= WINDOW
    return path


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_model_is_the_plain_version(case):
    make, shape, xl, yl = CASES[case]
    value = make(np.random.default_rng(23), shape)
    b, t_y, t_x = shape
    mask = ma.length_mask(torch.tensor(xl), torch.tensor(yl), t_x, t_y)
    want = ma.maximum_path_plain(torch.from_numpy(value).transpose(1, 2), mask).numpy()
    for r in (8, 16):
        warps = -(-t_x // (32 * r))
        p = ma.Plan(r, warps, 2, 4, 16, True, 1, 0)
        np.testing.assert_array_equal(kernel_model(value, xl, yl, p), want)
    if case.startswith("below zero"):  # JAX's path too (the plain version's gather rule)
        jax_path, _ = _jax_path(value, xl, yl)
        np.testing.assert_array_equal(want, jax_path)
