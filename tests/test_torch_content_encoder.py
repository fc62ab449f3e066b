"""PyTorch relative-position attention and content encoder == JAX.

The prior encoder at small width (hidden 16, filter 32, 2 heads, 2 layers,
window 4) on shared random weights, with ragged frame masks, including a
sequence shorter than the window. float32 on the CPU: atol 1e-4 / rtol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.models.attention import TransformerEncoder as JaxEncoder
from vcvits_tpu.models.content_encoder import HubertContentEncoder as JaxContentEncoder
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.attention import TransformerEncoder
from vcvits_tpu_torch.models.content_encoder import HubertContentEncoder
from vcvits_tpu_torch.models.hubert import HubertConfig

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-3)
HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)


def _random_params(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                        shapes)


@pytest.mark.parametrize("t,lens", [(23, (23, 17)), (3, (3, 2))])
def test_transformer_encoder(t, lens):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array(lens)[:, None]).astype(np.float32)[..., None]
    jm = JaxEncoder(16, 32, 2, 2, kernel_size=3)
    p = _random_params(jm, x, mask)
    ref = np.asarray(jax.jit(lambda p, x, m: jm.apply({"params": p}, x, m))(p, x, mask))
    tm = TransformerEncoder(16, 32, 2, 2, kernel_size=3)
    tm.load_state_dict(params_from_jax(p))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_content_encoder():
    rng = np.random.default_rng(5)
    b, t_wav = 2, 5120
    wav = (rng.standard_normal((b, t_wav)) * 0.2).astype(np.float32)
    lens = np.array([t_wav, 3000], np.int32)
    # out-of-range bins are clipped before the embedding
    pitch = rng.integers(-3, 70, (b, t_wav // 320))
    kw = dict(out_channels=8, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=2,
              kernel_size=3, num_pitch=64)
    jm = JaxContentEncoder(JaxHubertConfig(**HUBERT), p_dropout=0.0, **kw)
    p = _random_params(jm, wav, lens, pitch)
    ref = jax.jit(lambda p, w, l, pi: jm.apply({"params": p}, w, l, pi))(p, wav, lens, pitch)
    tm = HubertContentEncoder(HubertConfig(**HUBERT), **kw)
    tm.load_state_dict(params_from_jax(p))
    got = tm(torch.from_numpy(wav), torch.from_numpy(lens), torch.from_numpy(pitch))
    for name, g, r in zip(("x_out", "m_p", "logs_p", "x_mask"), got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), err_msg=name, **TOL)
