"""PyTorch port primitives == the JAX layers on shared random weights.

Weights and inputs are drawn with numpy, given to the flax module, and
carried to the port through `params_from_jax`. float32 on the CPU; the two
differ only in summation order, so atol 1e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.models import layers as jl
from vcvits_tpu.models.synthesizer import nearest_interp as jax_nearest_interp
from vcvits_tpu.utils.masking import sequence_mask as jax_sequence_mask
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models import layers as tl
from vcvits_tpu_torch.utils.masking import nearest_interp, sequence_mask

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


def _random_params(module, *args, seed=0, scale=0.3):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
                        shapes)


def _run_both(jmod, tmod, x):
    p = _random_params(jmod, x)
    ref = np.asarray(jax.jit(lambda p, x: jmod.apply({"params": p}, x))(p, x))
    tmod.load_state_dict(params_from_jax(p))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    return got, ref


@pytest.mark.parametrize("k,d,wn,pad", [(5, 3, True, "same"), (7, 1, True, (3, 3)),
                                         (3, 1, False, (1, 1)), (1, 1, False, "same")])
def test_conv1d(k, d, wn, pad):
    x = np.random.default_rng(1).standard_normal((2, 37, 6)).astype(np.float32)
    got, ref = _run_both(jl.Conv1d(10, k, dilation=d, weight_norm=wn, padding=pad),
                         tl.Conv1d(6, 10, k, dilation=d, weight_norm=wn, padding=pad), x)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2)])
def test_conv_transpose1d(k, u):
    x = np.random.default_rng(2).standard_normal((2, 9, 12)).astype(np.float32)
    got, ref = _run_both(
        jl.ConvTranspose1d(6, k, stride=u, padding=(k - u) // 2, weight_norm=True),
        tl.ConvTranspose1d(12, 6, k, stride=u, padding=(k - u) // 2, weight_norm=True), x)
    assert got.shape == (2, 9 * u, 6)
    np.testing.assert_allclose(got, ref, **TOL)


def test_layer_norm_and_linear():
    x = np.random.default_rng(3).standard_normal((2, 11, 8)).astype(np.float32) * 3 + 1
    got, ref = _run_both(jl.LayerNorm(8), tl.LayerNorm(8), x)
    np.testing.assert_allclose(got, ref, **TOL)
    import flax.linen as nn
    got, ref = _run_both(nn.Dense(5), tl.Linear(8, 5), x)
    np.testing.assert_allclose(got, ref, **TOL)


def test_leaky_relu():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(tl.leaky_relu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.leaky_relu(jnp.asarray(x))), **TOL)


def test_sequence_mask_and_nearest_interp():
    lens = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(sequence_mask(torch.from_numpy(lens), 9).numpy(),
                                  np.asarray(jax_sequence_mask(jnp.asarray(lens), 9)))
    x = np.random.default_rng(4).standard_normal((2, 50, 3)).astype(np.float32)
    for t_out in (1, 49, 50, 150, 937):
        np.testing.assert_array_equal(nearest_interp(torch.from_numpy(x), t_out).numpy(),
                                      np.asarray(jax_nearest_interp(jnp.asarray(x), t_out)))


def test_seeded_init_is_deterministic():
    a = tl.init_weights(tl.Conv1d(4, 6, 3, weight_norm=True, kernel_init="normal"), 7)
    b = tl.init_weights(tl.Conv1d(4, 6, 3, weight_norm=True, kernel_init="normal"), 7)
    assert torch.equal(a.v, b.v) and torch.equal(a.g, b.g)
    # weight norm starts at g = ||v||, so the folded kernel equals v
    torch.testing.assert_close(a.kernel(), a.v)
    assert abs(a.v.std().item() - 0.01) < 0.004
