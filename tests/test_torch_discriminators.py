"""The discriminators and spectral norm: the port == JAX.

MultiPeriodDiscriminator (periods 2, 3, 5: the scale head + three period
heads, one of them padding T) and MultiScaleDiscriminator (5 scales) on
shared random weights, JAX with its TPU rewrites on (im2col_first,
time_fold) and the port's plain convs. Every logit and every feature map
is compared. PitchDiscriminator as tests/test_aux_modules.py builds it
(n_scales=3, [2, 100, 1] contours), its weights carried by
params_from_jax: logits, feature maps, and the gradient of an LS-GAN loss
with respect to the generated contour. float32 on the CPU: atol 1e-4 x the tensor's largest value,
rtol 1e-4 (chains of up to 7 convs with 1024 channels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD, MultiScaleDiscriminator as JaxMSD,
    PitchDiscriminator as JaxPitchD)
from vcvits_tpu.models.layers import (
    Conv1d as JaxConv1d, Conv2dNorm as JaxConv2dNorm, spectral_normalize as jax_sn)
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.models.discriminators import (
    Discriminators, MultiPeriodDiscriminator, MultiScaleDiscriminator, PitchDiscriminator)
from vcvits_tpu_torch.models.layers import Conv1d, Conv2dNorm, spectral_normalize

torch.set_num_threads(1)
PERIODS = (2, 3, 5)


def _random(module, *args, seed=0, scale=0.2):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
                        shapes)


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((2, 1022, 1)) * 0.3).astype(np.float32)
    y_hat = np.tanh(rng.standard_normal((2, 1022, 1))).astype(np.float32)
    jmpd = JaxMPD(periods=PERIODS, im2col_first=True, time_fold=True)
    jmsd = JaxMSD(im2col_first=True, time_fold=True)
    d_params = {"mpd": _random(jmpd, y, y_hat, seed=2), "msd": _random(jmsd, y, y_hat, seed=3)}
    port = Discriminators(MultiPeriodDiscriminator(PERIODS, im2col_first=True, time_fold=True),
                          MultiScaleDiscriminator(im2col_first=True, time_fold=True))
    port.load_state_dict(disc_params_from_jax(d_params))
    return y, y_hat, jmpd, jmsd, d_params, port


@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_logits_and_feature_maps_match_jax(pair, which):
    y, y_hat, jmpd, jmsd, d_params, port = pair
    jm = jmpd if which == "mpd" else jmsd
    ref = jax.jit(lambda p: jm.apply({"params": p}, y, y_hat))(d_params[which])
    with torch.no_grad():
        got = getattr(port, which)(torch.from_numpy(y), torch.from_numpy(y_hat))
    n_heads = len(PERIODS) + 1 if which == "mpd" else 5
    for g_list, r_list in zip(got[:2], ref[:2]):  # logits real, generated
        assert len(g_list) == len(r_list) == n_heads
        for g, r in zip(g_list, r_list):
            _close(g, r)
    for g_heads, r_heads in zip(got[2:], ref[2:]):  # feature maps real, generated
        for g_maps, r_maps in zip(g_heads, r_heads):
            assert len(g_maps) == len(r_maps)
            for g, r in zip(g_maps, r_maps):
                _close(g, r)


@pytest.mark.parametrize("shape", [(5, 1, 16), (41, 4, 64), (5, 1, 1, 32)])
def test_spectral_normalize_matches_jax(shape):
    k = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_sn(jnp.asarray(k)))
    perm = (2, 1, 0) if len(shape) == 3 else (3, 2, 0, 1)
    got = spectral_normalize(torch.from_numpy(k.transpose(perm).copy())).numpy()
    np.testing.assert_allclose(got, ref.transpose(perm), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["weight", "spectral"])
def test_norm_convs_match_jax(norm):
    rng = np.random.default_rng(4)
    sn = norm == "spectral"
    x1 = rng.standard_normal((2, 40, 8)).astype(np.float32)
    jc1 = JaxConv1d(16, 5, stride=2, groups=2, padding=(2, 2), weight_norm=not sn,
                    spectral_norm=sn)
    p1 = _random(jc1, x1, seed=5)
    tc1 = Conv1d(8, 16, 5, stride=2, groups=2, padding=(2, 2), weight_norm=not sn,
                 spectral_norm=sn)
    tc1.load_state_dict(params_from_jax(p1))
    _close(tc1(torch.from_numpy(x1)), jc1.apply({"params": p1}, x1))

    x2 = rng.standard_normal((2, 20, 3, 4)).astype(np.float32)
    jc2 = JaxConv2dNorm(8, (5, 1), strides=(3, 1), padding=((2, 2), (0, 0)),
                        weight_norm=not sn, spectral_norm=sn)
    p2 = _random(jc2, x2, seed=6)
    tc2 = Conv2dNorm(4, 8, (5, 1), (3, 1), ((2, 2), (0, 0)), weight_norm=not sn,
                     spectral_norm=sn)
    tc2.load_state_dict(params_from_jax(p2))
    _close(tc2(torch.from_numpy(x2)), jc2.apply({"params": p2}, x2))


@pytest.fixture(scope="module")
def pitch_pair():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((2, 100, 1)).astype(np.float32)
    y_hat = rng.standard_normal((2, 100, 1)).astype(np.float32)
    jd = JaxPitchD(n_scales=3)
    params = _random(jd, y, y_hat, seed=8)
    port = PitchDiscriminator(n_scales=3)
    port.load_state_dict(params_from_jax(params))
    return y, y_hat, jd, params, port


def test_pitch_discriminator_matches_jax(pitch_pair):
    y, y_hat, jd, params, port = pitch_pair
    ref = jax.jit(lambda p: jd.apply({"params": p}, y, y_hat))(params)
    with torch.no_grad():
        got = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    for g_list, r_list in zip(got[:2], ref[:2]):
        assert len(g_list) == len(r_list) == 3
        for g, r in zip(g_list, r_list):
            _close(g, r)
    for g_heads, r_heads in zip(got[2:], ref[2:]):
        for g_maps, r_maps in zip(g_heads, r_heads):
            assert len(g_maps) == len(r_maps) == 5
            for g, r in zip(g_maps, r_maps):
                _close(g, r)


def test_pitch_discriminator_gradient_matches_jax(pitch_pair):
    """d/d y_hat of sum_i mean((1 - D_i(y))^2) + mean(D_i(y_hat)^2)."""
    y, y_hat, jd, params, port = pitch_pair

    def loss(yh):
        lr, lg, _, _ = jd.apply({"params": params}, y, yh)
        return sum(jnp.mean((1.0 - a) ** 2) for a in lr) + sum(jnp.mean(a ** 2) for a in lg)

    ref = jax.jit(jax.grad(loss))(y_hat)
    yh = torch.from_numpy(y_hat).requires_grad_(True)
    lr, lg, _, _ = port(torch.from_numpy(y), yh)
    (sum(torch.mean((1.0 - a) ** 2) for a in lr) + sum(torch.mean(a ** 2) for a in lg)).backward()
    _close(yh.grad, ref)
