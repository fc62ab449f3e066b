"""The W8A8 decode's fused epilogue and stage driver (ops/int8_conv.py) on
the CPU, against the module path they replace, bit for bit.

* The W8A8 generator (`HiFiGANGenerator.forward` with quant_int8=True,
  which runs `w8a8_forward` and `mrf_w8a8`) equals the module path it
  replaces: conv_pre, the speaker term added, per stage the upsampler and
  ResBlock1/2.module_forward of each block, summed and divided by the
  `block_count` tensor, conv_post and tanh (`torch.equal`): fp32 and bf16,
  ResBlock1 and ResBlock2, with and without g, at B = 1 and on a ragged
  batch of 3 (rows zero after their lengths).
* `conv1d_w8a8_plain` with the residual (a full one, and a per-row term),
  the partial sum, the division and the emitted row maximum equals the
  composition of the existing ops, and the emitted maximum is
  `row_absmax_plain` of the output with the consumer's slope (folded into
  what the slot held).
* `row_absmax` with a decode's slots puts the maximum in slot 0 and zeroes
  the rest; `mrf_w8a8` draws `mrf_w8a8_slots` slots.
* `plan` at every distinct conv of a 10 s request fits the card's shared
  memory and covers every column tile.
float32 and bfloat16 on the CPU; no JAX.
"""

import numpy as np
import pytest
import torch

from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
from vcvits_tpu_torch.models.layers import LRELU_SLOPE
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.int8_conv import (
    MAX_SMEM, TILES, W8A8Conv, conv1d_w8a8, conv1d_w8a8_plain, mrf_w8a8, mrf_w8a8_slots, plan,
    prepare_w8a8, row_absmax, row_absmax_plain)

torch.set_num_threads(1)

KW = dict(initial_channel=16, resblock_kernel_sizes=(3, 7),
          resblock_dilation_sizes=((1, 3), (1, 5)), upsample_rates=(8, 8, 4, 2),
          upsample_initial_channel=64, upsample_kernel_sizes=(16, 16, 4, 4), gin_channels=8)


def module_path(m: HiFiGANGenerator, x: torch.Tensor, g) -> torch.Tensor:
    """The W8A8 generator as the modules compute it, one op at a time."""
    x = m.conv_pre(x)
    if g is not None and m.cond is not None:
        x = x + m.cond(g)[:, None, :]
    for i in range(m.n_stages):
        x = getattr(m, f"up_{i}")(x, act_slope=LRELU_SLOPE).contiguous()
        xs = getattr(m, f"res_{i}_0").module_forward(x)
        for j in range(1, len(m.kernel_sizes)):
            xs = xs + getattr(m, f"res_{i}_{j}").module_forward(x)
        x = xs / m.block_count
    return torch.tanh(m.conv_post(x, act_slope=0.01))


@pytest.fixture(scope="module")
def generators():
    """Per (resblock, dtype) a generator on random parameters of scale 0.3
    from a seed (neither silent nor saturated, unlike the initialisers')."""
    out = {}
    for rb in ("1", "2"):
        for dt in (torch.float32, torch.bfloat16):
            m = HiFiGANGenerator(resblock=rb, quant_int8=True, dtype=dt, **KW)
            rng = np.random.default_rng(3)
            with torch.no_grad():
                for prm in m.parameters():
                    prm.copy_(torch.tensor(rng.standard_normal(tuple(prm.shape)) * 0.3))
            out[(rb, dt)] = m
    return out


@pytest.mark.parametrize("batch", ["B=1", "ragged B=3"])
@pytest.mark.parametrize("with_g", [True, False])
@pytest.mark.parametrize("resblock", ["1", "2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_driver_equals_module_path(generators, dtype, resblock, with_g, batch):
    m = generators[(resblock, dtype)]
    rng = np.random.default_rng(0)
    b, lengths = (1, (13,)) if batch == "B=1" else (3, (13, 9, 4))
    x = torch.tensor(rng.standard_normal((b, 13, 16)), dtype=torch.float32)
    for row, n in enumerate(lengths):
        x[row, n:] = 0.0  # a padded row, as a batch of shorter requests
    g = torch.tensor(rng.standard_normal((b, 8)), dtype=torch.float32).to(dtype) \
        if with_g else None
    x = x.to(dtype)
    before = sum(_build.LAUNCHES.values())
    with torch.no_grad():
        got, want = m(x, g), module_path(m, x, g)
    assert got.shape == want.shape == (b, 13 * 512, 1) and got.dtype == dtype
    assert torch.isfinite(got.float()).all() and 0.01 < got.float().abs().mean() < 0.9
    assert torch.equal(got, want)
    assert sum(_build.LAUNCHES.values()) == before  # the plain versions, no launch on the CPU


def _conv_inputs(dtype, b=2, t=40, ci=12, co=10, k=3):
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((b, t, ci)), dtype=torch.float32).to(dtype)
    qw = prepare_w8a8(torch.tensor(rng.standard_normal((co, ci, k)) * 0.2, dtype=torch.float32))
    bias = torch.tensor(rng.standard_normal(co) * 0.1, dtype=torch.float32)
    res = torch.tensor(rng.standard_normal((b, t, co)), dtype=torch.float32).to(dtype)
    acc = torch.tensor(rng.standard_normal((b, t, co)), dtype=torch.float32).to(dtype)
    row = torch.tensor(rng.standard_normal((b, 1, co)), dtype=torch.float32).to(dtype)
    return x, qw, bias, res, acc, row


@pytest.mark.parametrize("emit_slope", [0.1, 0.01, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_epilogue_is_the_composition_of_ops(dtype, emit_slope):
    x, qw, bias, res, acc, row = _conv_inputs(dtype)
    amax = row_absmax_plain(x, 0.1)
    conv = conv1d_w8a8_plain(x, qw, (1, 1), bias, 1, 0.1)
    assert torch.equal(conv1d_w8a8_plain(x, qw, (1, 1), bias, 1, 0.1, amax=amax), conv)
    three = torch.tensor(3.0)
    cases = {"residual": (dict(residual=res), conv + res),
             "per-row term": (dict(residual=row), conv + row),
             "sum": (dict(residual=res, accum=acc), acc + (conv + res)),
             "mean": (dict(residual=res, accum=acc, divisor=3.0), (acc + (conv + res)) / three)}
    for name, (fused, want) in cases.items():
        held = torch.full((2,), 0.25)  # a slot that held a smaller maximum already
        got = conv1d_w8a8(x, qw, (1, 1), bias, 1, 0.1, amax=amax, emit=held,
                          emit_slope=emit_slope, **fused)
        assert got.dtype == dtype and torch.equal(got, want), name
        assert torch.equal(held, torch.clamp_min(row_absmax_plain(got, emit_slope), 0.25)), name


def test_row_absmax_fills_slot_zero_and_zeroes_the_rest():
    x = torch.tensor(np.random.default_rng(5).standard_normal((3, 50, 8)), dtype=torch.float32)
    slots = torch.full((6, 3), 7.0)
    got = row_absmax(x, None, slots)
    assert torch.equal(got, row_absmax_plain(x)) and torch.equal(slots[0], got)
    assert torch.equal(slots[1:], torch.zeros(5, 3))
    with pytest.raises(ValueError):
        row_absmax(x, None, torch.zeros(6, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_w8a8_draws_its_slots_and_fills_them(dtype):
    """ResBlock1-shaped blocks ((c1, c2) steps): the driver draws one slot
    per conv but each block's last, each filled with the row maximum of
    the conv's output under the next conv's slope; the stage's mean goes to
    `emit`."""
    rng = np.random.default_rng(6)
    c, t = 8, 30

    def conv(k, d):
        w = torch.tensor(rng.standard_normal((c, c, k)) * 0.3, dtype=torch.float32)
        p = (k - 1) // 2 * d
        return W8A8Conv(prepare_w8a8(w), (p, p), torch.zeros(c), d)

    blocks = [[(conv(3, 1), conv(3, 1)), (conv(3, 3), conv(3, 1))],
              [(conv(5, 1), conv(5, 1))]]
    assert mrf_w8a8_slots(blocks) == 3 + 1
    x = torch.tensor(rng.standard_normal((2, t, c)), dtype=torch.float32).to(dtype)
    slots = torch.zeros(mrf_w8a8_slots(blocks) + 1, 2)
    free = iter(slots[:-1])
    out = mrf_w8a8(x, row_absmax_plain(x, 0.1), blocks, 0.1, free, slots[-1], 0.01)
    assert next(free, None) is None
    assert torch.equal(slots[-1], row_absmax_plain(out, 0.01))
    h = conv1d_w8a8_plain(x, blocks[0][0][0].qw, (1, 1), None, 1, 0.1)
    assert torch.equal(slots[0], row_absmax_plain(h, 0.1))
    assert (slots[:-1] > 0).all()


def test_plan_fits_every_decoder_conv():
    """The tiles of a 10 s request's convs (48k_base, B = 1 and 16): within
    the shared memory, every column tile covered, Co <= 32 without padded
    tiles, and a block an SM at least where the shape has as many pairs of
    column tile and (row, frame tile)."""
    frames, c = 930, 512
    convs = [(128, 512, 7, 1, frames)]
    for u, k in zip((8, 8, 4, 2), (16, 16, 4, 4)):
        k_phase = 1 if k == u else 3
        convs.append((c, u * (c // 2), k_phase, 1, frames))
        c, frames = c // 2, frames * u
        convs += [(c, c, rk, d, frames) for rk in (3, 7, 11) for d in (1, 3, 5)]
    convs.append((c, 1, 7, 1, frames))
    for ci, co, k, d, t in convs:
        for b in (1, 16):
            p = plan(ci, co, k, d, t, b, b == 16)
            bm, bn, _, _ = TILES[p.tile]
            assert p.smem <= MAX_SMEM and p.nt * p.groups * bn >= co
            assert (p.groups - 1) * p.nt * bn < co  # no block without a column
            assert bn <= 8 if co == 1 else (bn == 32 if co == 32 else bn == 64)
            assert p.ring == p.nt * k or p.ring in (2, 3)
            items = -(-t // bm) * b  # (row, frame tile) pairs a column group walks
            assert 1 <= p.persist <= items and p.prefetch in (0, 1)
            assert p.groups * p.persist >= min(132, -(-co // bn) * items)
    with pytest.raises(ValueError):
        plan(513, 8, 3, 1)
    with pytest.raises(ValueError):
        plan(32, 8, 14, 5)
