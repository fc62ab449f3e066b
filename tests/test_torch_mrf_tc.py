"""The host side of K1's tensor-core kernel (csrc/mrf.cu), on the CPU.

* A NumPy model of 3xTF32 as the kernel does it (weights split hi + lo, both
  rounded to TF32; activations' lo passed as fp32 and cut to TF32 by the
  tensor cores; fp32 sums) on one C = 256, k = 11 conv, against float64:
  within 1e-5 x RMS, where one TF32 product per multiply-add is above 1e-4.
* The fused (block, dilation) pair computed tile by tile with `plan`'s rows
  and halo, u zeroed on rows outside [0, T), in PyTorch: equal to
  `mrf_plain` on the whole sequence within 1e-6 of the output's largest
  value (a few float32 ulps) at dilations 1/3/5,
  for T below the halo, T not a multiple of the tile and batch 2.
* `plan` fits every stage of configs/48k_base.json and configs/base.json
  in 227 KB of shared memory and refuses the sizes the kernel does not take.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vcvits_tpu_torch.ops.mrf import MAX_SMEM, launches_per_stage, mrf_plain, plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: float32 to a 10-bit mantissa, nearest, ties away."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_cut(x: np.ndarray) -> np.ndarray:
    """What the tensor cores read of a float32 operand: its low 13 bits dropped."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _conv_valid(x: np.ndarray, w: np.ndarray, d: int, dtype) -> np.ndarray:
    """sum over taps m of x[m*d : m*d + rows] @ w[m], summed in `dtype`."""
    k = w.shape[0]
    rows = x.shape[0] - (k - 1) * d
    return sum(x[m * d:m * d + rows].astype(dtype) @ w[m].astype(dtype) for m in range(k))


def test_3xtf32_model_meets_1e5_where_tf32_does_not():
    rng = np.random.default_rng(0)
    c, k, d, rows = 256, 11, 5, 64
    x = rng.standard_normal((rows + (k - 1) * d, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, c)) / np.sqrt(k * c)).astype(np.float32)
    exact = _conv_valid(x, w, d, np.float64)
    rms = np.sqrt(np.mean(exact ** 2))
    x_hi = _tf32_rna(x)
    x_lo = _tf32_cut(x - x_hi)
    w_hi = _tf32_rna(w)
    w_lo = _tf32_rna(w - w_hi)
    # the kernel's order: lo*hi + hi*lo + hi*hi, every product exact, fp32 sums
    three = (_conv_valid(x_lo, w_hi, d, np.float32) + _conv_valid(x_hi, w_lo, d, np.float32)
             + _conv_valid(x_hi, w_hi, d, np.float32))
    one = _conv_valid(x_hi, w_hi, d, np.float32)
    err3 = np.abs(three - exact).max() / rms
    err1 = np.abs(one - exact).max() / rms
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1


def _pair_tiled(h, w1, b1, w2, b2, k, d):
    """One (block, dilation) pair as csrc/mrf.cu computes it: per tile of
    `plan(...).out_rows` output rows, the staged input rows with the halo
    (zeros outside [0, T)), conv1 over `rows` rows, u zeroed outside
    [0, T), conv2, the residual."""
    bsz, t_len, c = h.shape
    p = plan(c, k, d, w1.dtype)
    assert p.halo == (k - 1) // 2 * (d + 1) and p.span == p.out_rows + 2 * p.halo
    wf1, wf2 = w1.float().permute(2, 1, 0), w2.float().permute(2, 1, 0)
    out = torch.empty_like(h)
    for t0 in range(0, t_len, p.out_rows):
        times = torch.arange(p.span) + t0 - p.halo
        inside = (times >= 0) & (times < t_len)
        xt = torch.zeros(bsz, p.span, c)
        xt[:, inside] = h[:, times[inside]]
        xt = F.leaky_relu(xt, 0.1).to(w1.dtype).float()
        # "valid" convs (no padding): the staged rows are the padding
        u = F.conv1d(xt.transpose(1, 2), wf1, b1.float(), dilation=d).transpose(1, 2)
        assert u.shape[1] == p.rows
        u = F.leaky_relu(u, 0.1)
        u_times = torch.arange(p.rows) + t0 - (k - 1) // 2
        u[:, (u_times < 0) | (u_times >= t_len)] = 0.0
        u = torch.cat([u.to(w1.dtype).float(), torch.zeros(bsz, k - 1, c)], dim=1)
        y = F.conv1d(u.transpose(1, 2), wf2, b2.float()).transpose(1, 2)
        n = min(p.out_rows, t_len - t0)
        out[:, t0:t0 + n] = h[:, t0:t0 + n] + y[:, :n]
    return out


def _mrf_tiled(x, blocks, kernel_sizes, dilations):
    total = None
    for (w1, b1, w2, b2), k, dils in zip(blocks, kernel_sizes, dilations):
        h = x
        for t, d in enumerate(dils):
            h = _pair_tiled(h, w1[t], b1[t], w2[t], b2[t], k, d)
        total = h if total is None else total + h
    return total / len(blocks)


@pytest.mark.parametrize("c,t,batch", [(32, 20, 1), (32, 1100, 2), (256, 150, 1),
                                       (128, 119, 1)])
def test_tiled_pairs_equal_plain(c, t, batch):
    """T 20 is below the 30-row halo of k 11 at d 5; 1100, 150 and 119 are
    not multiples of the tiles (502, 54 and 118 output rows at k 11)."""
    torch.manual_seed(0)
    rng = np.random.default_rng(c + t)
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    x = torch.tensor(rng.standard_normal((batch, t, c)), dtype=torch.float32)
    blocks = []
    for k, dil in zip(ks, ds):
        n = len(dil)
        blocks.append(tuple(torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32)
                            for s, sc in (((n, k, c, c), 1 / np.sqrt(k * c)), ((n, c), 0.5),
                                          ((n, k, c, c), 1 / np.sqrt(k * c)), ((n, c), 0.5))))
    with torch.no_grad():
        got = _mrf_tiled(x, blocks, ks, ds)
        ref = mrf_plain(x, blocks, ks, ds)
    # 1e-6 of the largest output: a few float32 ulps, as the two sum in
    # different orders over different lengths
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


def test_tiled_pair_needs_u_zeroed():
    """Without zeroing u outside [0, T) the bias leaks into conv2's padding
    and the tiles no longer equal the plain version: the zeroing is what
    the test above holds."""
    rng = np.random.default_rng(1)
    c, t, k, d = 32, 40, 3, 1
    h = torch.tensor(rng.standard_normal((1, t, c)), dtype=torch.float32)
    w1, w2 = (torch.tensor(rng.standard_normal((k, c, c)) / np.sqrt(k * c),
                           dtype=torch.float32) for _ in range(2))
    b1, b2 = torch.full((c,), 0.5), torch.zeros(c)
    blk = (w1[None], b1[None], w2[None], b2[None])
    ref = mrf_plain(h, [blk], (k,), ((d,),))
    # the same pair with u's padding rows lrelu(b1) instead of 0
    u = F.leaky_relu(F.conv1d(F.leaky_relu(h, 0.1).transpose(1, 2), w1.permute(2, 1, 0), b1,
                              padding=1), 0.1)
    edge = F.leaky_relu(b1, 0.1)[None, :, None]
    leaked = h + F.conv1d(torch.cat([edge, u, edge], dim=2), w2.permute(2, 1, 0)).transpose(1, 2)
    assert (leaked - ref).abs().max().item() > 1e-2
    assert (_pair_tiled(h, w1, b1, w2, b2, k, d) - ref).abs().max().item() <= 1e-6


def _stage_shapes(path):
    with open(os.path.join(REPO, path)) as f:
        m = json.load(f)["model"]
    c0 = m["upsample_initial_channel"]
    return [(c0 // 2 ** (i + 1), k, d) for i in range(len(m["upsample_rates"]))
            for k, dils in zip(m["resblock_kernel_sizes"], m["resblock_dilation_sizes"])
            for d in dils], m["resblock_dilation_sizes"]


@pytest.mark.parametrize("config", ["configs/48k_base.json", "configs/base.json"])
def test_plan_fits_every_stage(config):
    shapes, dilations = _stage_shapes(config)
    assert len(shapes) == 4 * launches_per_stage(dilations) == 36
    for c, k, d in shapes:
        for wdt in (torch.float32, torch.bfloat16):
            p = plan(c, k, d, wdt)
            assert p.smem <= MAX_SMEM
            assert p.threads <= 256 and p.rows % 64 == 0 and p.out_rows == p.rows - (k - 1)
            assert p.span == p.out_rows + 2 * p.halo == p.rows + (k - 1) * d


@pytest.mark.parametrize("c,k,d,wdt", [(48, 3, 1, torch.float32), (512, 3, 1, torch.float32),
                                       (64, 4, 1, torch.bfloat16), (64, 3, 0, torch.float32),
                                       (256, 11, 60, torch.float32),
                                       (256, 11, 120, torch.bfloat16)])
def test_plan_refuses(c, k, d, wdt):
    with pytest.raises(ValueError):
        plan(c, k, d, wdt)
