"""PyTorch HiFi-GAN decoder and ops/mrf.py == JAX.

* ResBlock1 (one block through ops/mrf.py) against flax ResBlock1.
* The plain version of kernel K1 against `mrf_fused(interpret=True)` (the
  Pallas kernel body) at several tiles, T not a multiple of the tile, and
  against the mean of the port's blocks taken one at a time and of the JAX
  ResBlock1 loops; atol 2e-5 as tests/test_mrf_pallas.py.
* The generator at small width against flax HiFiGANGenerator with
  fold_tail=True (its fold is exact), and at the exact 48k_base decoder
  widths on 4 input frames (2048 samples), the one CPU check that covers
  the C=256 stage, where JAX never takes its fused kernel.
float32 on the CPU; generators atol 1e-5 / rtol 1e-4 on the tanh output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from vcvits_tpu.models.hifigan import ResBlock1 as JaxResBlock1
from vcvits_tpu.ops.mrf_pallas import fold_resblock_weights, mrf_fused
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock1
from vcvits_tpu_torch.ops.mrf import mrf_plain

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (3, 7)
DS = ((1, 3), (1, 5))
CH = 16


def _random_params(module, *args, seed=0, scale=0.3):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
                        shapes)


@pytest.fixture(scope="module")
def blocks():
    x = np.random.default_rng(0).standard_normal((2, 70, CH)).astype(np.float32)
    out = []
    for i, (k, d) in enumerate(zip(KS, DS)):
        jm = JaxResBlock1(CH, k, d)
        p = _random_params(jm, x, seed=10 + i)
        tm = ResBlock1(CH, k, d)
        tm.load_state_dict(params_from_jax(p))
        out.append((jm, p, tm))
    return x, out


def test_resblock1_module_loop(blocks):
    x, bl = blocks
    for jm, p, tm in bl:
        ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, x)
        got = tm(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("t,tile", [(70, 16), (70, 32), (64, None), (9, 8)])
def test_mrf_plain_matches_pallas_interpret(blocks, t, tile):
    x, bl = blocks
    x = x[:, :t]
    jw = [fold_resblock_weights(p, "1", len(d), jnp.float32) for (_, p, _), d in zip(bl, DS)]
    ref = np.asarray(mrf_fused(jnp.asarray(x), jw, KS, DS, tile=tile, interpret=True))
    with torch.no_grad():
        tw = [tm.stacked_weights(torch.float32) for _, _, tm in bl]
    for (w1, b1, w2, b2), (jw1, jb1, jw2, jb2) in zip(tw, jw):  # same stacked layout
        np.testing.assert_allclose(w1.numpy(), np.asarray(jw1), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(b2.numpy(), np.asarray(jb2)[:, 0], atol=1e-6, rtol=1e-5)
    got = mrf_plain(torch.from_numpy(x), tw, KS, DS).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    with torch.no_grad():
        loop = sum(tm(torch.from_numpy(x)) for _, _, tm in bl) / len(bl)
    np.testing.assert_allclose(got, loop.numpy(), atol=2e-5, rtol=1e-4)
    jax_loop = sum(np.asarray(jm.apply({"params": p}, x)) for jm, p, _ in bl) / len(bl)
    np.testing.assert_allclose(got, jax_loop, atol=2e-5, rtol=1e-4)


def _generator_pair(kw, n_frames, seed, scale):
    x = np.random.default_rng(seed).standard_normal((1, n_frames, kw["initial_channel"]))
    x = x.astype(np.float32)
    g = np.random.default_rng(seed + 1).standard_normal((1, kw["gin_channels"]))
    g = g.astype(np.float32)
    jm = JaxGenerator(fold_tail=True, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, g=g))["params"]
    rng = np.random.default_rng(seed + 2)
    p = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
                     shapes)
    ref = np.asarray(jax.jit(lambda p, x, g: jm.apply({"params": p}, x, g=g))(p, x, g))
    tm = HiFiGANGenerator(**kw)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    return got, ref


def test_generator_small():
    kw = dict(initial_channel=8, resblock="1", resblock_kernel_sizes=KS,
              resblock_dilation_sizes=DS, upsample_rates=(4, 2),
              upsample_initial_channel=32, upsample_kernel_sizes=(8, 4), gin_channels=4)
    got, ref = _generator_pair(kw, n_frames=12, seed=3, scale=0.3)
    assert got.shape == ref.shape == (1, 96, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_generator_full_width_48k():
    m = load_config(os.path.join(ROOT, "configs", "48k_base.json")).model
    kw = dict(initial_channel=m.inter_channels, resblock=m.resblock,
              resblock_kernel_sizes=m.resblock_kernel_sizes,
              resblock_dilation_sizes=m.resblock_dilation_sizes,
              upsample_rates=m.upsample_rates,
              upsample_initial_channel=m.upsample_initial_channel,
              upsample_kernel_sizes=m.upsample_kernel_sizes, gin_channels=m.gin_channels)
    got, ref = _generator_pair(kw, n_frames=4, seed=7, scale=0.2)
    assert got.shape == ref.shape == (1, 2048, 1)
    assert 0.01 < np.abs(ref).mean() < 0.9  # neither silent nor saturated
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
