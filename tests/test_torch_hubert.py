"""PyTorch HuBERT == the JAX HubertModel on shared random weights.

A 2-layer HuBERT at width 32 with a shortened conv front end (same 320x
downsample structure: no conv bias, GroupNorm on conv 0, erf-GELU), the
even-kernel grouped positional conv, post-LN layers, with and without a
frame mask. float32 on the CPU: atol 1e-4 / rtol 1e-3 (twelve LayerNorms
and softmaxes deep, summation order only).
"""

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.models.hubert import HubertModel as JaxHubert
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.hubert import HubertConfig, HubertModel

torch.set_num_threads(1)

SMALL = dict(conv_layers=((32, 10, 5), (32, 8, 8), (32, 8, 8)), hidden_size=32, num_layers=2,
             num_heads=4, intermediate_size=64, pos_conv_kernel=8, pos_conv_groups=4)


@pytest.fixture(scope="module")
def pair():
    jm = JaxHubert(JaxHubertConfig(**SMALL))
    wav = np.random.default_rng(0).standard_normal((2, 6480)).astype(np.float32) * 0.3
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), wav))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    tm = HubertModel(HubertConfig(**SMALL))
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm, wav


@pytest.mark.parametrize("masked", [False, True])
def test_hubert_matches_jax(pair, masked):
    jm, params, tm, wav = pair
    t = 6480 // 320
    mask = (np.arange(t)[None, :] < np.array([[t], [t - 6]])).astype(np.float32) if masked \
        else None
    ref = np.asarray(jax.jit(lambda p, w, m: jm.apply({"params": p}, w, m))(params, wav, mask))
    got = tm(torch.from_numpy(wav), None if mask is None else torch.from_numpy(mask))
    assert got.shape == ref.shape == (2, t, 32)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4, rtol=1e-3)
