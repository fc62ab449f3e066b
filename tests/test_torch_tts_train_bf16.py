"""The TTS train step in bfloat16: TTSTrainStep(dtype=bfloat16) against
JAX's make_tts_train_step(dtype=bfloat16), on the CPU.

The tiny configuration, weights, batch, replayed draws (the posterior's
eps drawn in bf16, as posterior.py draws it in m's dtype) and the Dropout
patch of tests/test_torch_tts_train.py. bf16 cannot match exactly (XLA
keeps fused intermediates in float32, torch's CPU rounds after every op,
and Adam's first step moves each parameter by about lr * sign(g)), so
each loss and grad norm is held as the conversion step's bf16 test holds
them (tests/test_torch_train_step_bf16.py):

* within `RTOL` (0.1) of JAX's bf16 value;
* |port_bf16 - jax_bf16| <= 2 |jax_bf16 - fp32| + 2^-8 |jax_bf16|, with
  fp32 the port's float32 step on the same inputs (held to JAX's float32
  step at rtol 1e-3 in tests/test_torch_tts_train.py), so that compiling
  JAX's float32 step a second time is not needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tts_train import (
    CFG, N_VOCAB, jax_tts_draws, jax_weights, no_jax_dropout, tts_batch)
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.train.state import create_train_state
from vcvits_tpu.train.tts_step import make_tts_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.train.tts_step import TTSTrainStep

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 0.1
ATOL_SHARE = 2.0 ** -8


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        jcfg, cfg = JaxConfig.from_dict(CFG), Config.from_dict(CFG)
        batch = tts_batch()
        g_params, d_params = jax_weights(jcfg, batch)
        state = create_train_state(jcfg, g_params, d_params, freeze_hubert=False)
        key = jax.random.PRNGKey(7)
        step = jax.jit(make_tts_train_step(jcfg, dtype=jnp.bfloat16, n_vocab=N_VOCAB))
        _, jbf = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        jbf = {k: float(v) for k, v in jbf.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        port = TTSTrainStep(cfg, device="cpu", g_state=params_from_jax(g_params),
                            d_state=disc_params_from_jax(d_params), n_vocab=N_VOCAB,
                            dropout=False, dtype=dtype)
        before = {n: p.detach().clone() for n, p in port.gen.named_parameters()}
        got = port(tbatch, jax_tts_draws(key, batch, jcfg, jdtype))
        out[dtype] = (port, before, {k: float(v) for k, v in got.items()})
    return jbf, out


def test_bf16_metrics_within_rtol_of_jax_bf16(run):
    jbf, out = run
    got = out[torch.bfloat16][2]
    assert set(got) == set(jbf)
    for k, v in jbf.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)


def test_bf16_metrics_within_twice_own_bf16_error(run):
    jbf, out = run
    got, f32 = out[torch.bfloat16][2], out[torch.float32][2]
    for k, v in jbf.items():
        bound = 2 * abs(v - f32[k]) + ATOL_SHARE * abs(v)
        assert abs(got[k] - v) <= bound, (k, got[k], v, f32[k])


def test_bf16_step_keeps_float32_state_and_trains(run):
    _, out = run
    port, before, got = out[torch.bfloat16]
    assert all(np.isfinite(v) for v in got.values())
    for n, p in port.gen.named_parameters():
        assert p.dtype == torch.float32, n
        assert not torch.equal(p, before[n]), n
    assert all(port.g_opt.state[p]["exp_avg"].dtype == torch.float32 for p in port.g_params)
