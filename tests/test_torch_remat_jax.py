"""The port's "dots" remat step against JAX's "dots" step (`make_train_step`
with jax.checkpoint and checkpoint_dots around the generator's training
forward and the discriminators' forward) on tests/test_torch_train_step.py's
tiny config, shared weights and JAX's injected draws: every metric, the
generator's gradients and the whole step's discriminator gradients at that
test's tolerances. The other remat tests are in test_torch_remat.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_train_step import (
    ATOL, CFG, D_CHAINED_SHARE, G_SHARE, HUBERT, RTOL, _adam_mu, _assert_mu_close, _batch,
    _draw, _jax_draws)
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.state import create_train_state
from vcvits_tpu.train.step import init_params, make_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)


def test_dots_step_matches_jax_dots_step():
    raw = copy.deepcopy(CFG)
    raw["train"]["remat_policy"] = "dots"
    jcfg, cfg = JaxConfig.from_dict(raw), Config.from_dict(raw)
    hub = JaxHubertConfig(**HUBERT)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_shapes, d_shapes = jax.eval_shape(
        lambda: init_params(jcfg, jax.random.PRNGKey(0), jbatch, hubert_cfg=hub))
    rng = np.random.default_rng(1)
    g_params, d_params = (jax.tree.map(lambda s: _draw(rng, s.shape), t)
                          for t in (g_shapes, d_shapes))
    key = jax.random.PRNGKey(7)
    state1, metrics = jax.jit(make_train_step(jcfg, hubert_cfg=hub))(
        create_train_state(jcfg, g_params, d_params), jbatch, key)

    port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT),
                     g_state=params_from_jax(g_params), d_state=disc_params_from_jax(d_params))
    got = port({k: torch.from_numpy(v) for k, v in batch.items()}, _jax_draws(key, batch, jcfg))
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_mu_close(port.gen, port.g_opt, params_from_jax(_adam_mu(state1.g_opt_state)),
                     G_SHARE)
    _assert_mu_close(port.disc, port.d_opt, disc_params_from_jax(_adam_mu(state1.d_opt_state)),
                     D_CHAINED_SHARE)
