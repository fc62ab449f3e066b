"""The GAN train step in bfloat16: the port's TrainStep(dtype=bfloat16)
against JAX's make_train_step(dtype=bfloat16), on the CPU.

The tiny configuration, weights, batch and replayed draws of
tests/test_torch_train_step.py; JAX's posterior noise is drawn in bf16
(posterior.py draws it in m's dtype) and injected as such. bf16 cannot
match exactly: XLA fuses elementwise chains and may keep their
intermediates in float32 (a conv's bias, for one), torch's CPU rounds
after every op, and the Adam step moves each parameter by about
lr * sign(g), where bf16 flips the sign of many small gradients. So each
loss and grad norm is held two ways, with the values measured on these
inputs (torch 2.13, jax 0.9):

* the stated tolerance: within `RTOL` (0.1) of JAX's bf16 value. Largest
  measured: grad_norm_g 4.9e-2 (1.431e7 against 1.505e7; JAX's own fp32
  value is 1.299e7), loss/g/kl and loss/g/total 3.9e-2, every D metric
  below 1.6e-2 (loss/d_p_r/2).
* a bound no fault can hide behind: |port_bf16 - jax_bf16| <=
  2 |jax_bf16 - jax_fp32| + `ATOL_SHARE` (2^-8, bf16's unit roundoff) x
  |jax_bf16|. The G half's metrics come from the whole step; the D
  half's from the D half alone on JAX's bf16-updated generator, since in
  the whole step the discriminators run on the port's own updated
  generator, whose sign-noise moves are not JAX's. Closest to the bound:
  loss/d_p_r/2 (a real-input term, so bf16 arithmetic alone), 1.16e-3
  against 2 x 5.3e-4 + 2.8e-4 = 1.35e-3; loss/d_p_g/0 0.35 of its
  bound, loss/d_s_r/3 0.22, grad_norm_g 0.18 (7.4e5 against 4.1e6 +
  5.9e4).

The port's bf16 convolutions run on the CPU as float32 convolutions of
the bf16 operands (models/layers.py:conv_op): torch's CPU bf16 conv gets
the tiny HuBERT's positional conv (kernel 8, 8 channels a group) wrong.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import CFG, HUBERT, _batch, _draw
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.state import create_train_state
from vcvits_tpu.train.step import init_params, make_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.train.step import StepDraws, TrainStep, _Sections

torch.set_num_threads(1)

RTOL = 0.1
ATOL_SHARE = 2.0 ** -8


def _jax_draws(key, batch, cfg, dtype):
    """As tests/test_torch_train_step.py:_jax_draws, the noise in `dtype`."""
    b, hop = batch["y_wav"].shape[0], cfg.data.hop_length
    t_spec = batch["y_wav"].shape[1] // hop
    seg = cfg.train.segment_size // hop
    lens = jnp.asarray(batch["y_wav_lengths"]) // hop

    def one(r_sample):
        r_post, r_slice = jax.random.split(r_sample)
        eps = jax.random.normal(r_post, (b, t_spec, cfg.model.inter_channels), dtype)
        u = jax.random.uniform(r_slice, (b,))
        ids = jnp.floor(u * jnp.maximum(lens - seg + 1, 1).astype(u.dtype)).astype(jnp.int32)
        return (torch.from_numpy(np.array(eps.astype(jnp.float32))),
                torch.from_numpy(np.array(ids)))

    r_sample, _ = jax.random.split(key)
    r_sample2, _ = jax.random.split(jax.random.fold_in(key, 1))
    (eps, ids), (eps2, ids2) = one(r_sample), one(r_sample2)
    return StepDraws(eps=eps, ids_str=ids, eps2=eps2, ids_str2=ids2)


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = JaxConfig.from_dict(CFG), Config.from_dict(CFG)
    hub = JaxHubertConfig(**HUBERT)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_shapes, d_shapes = jax.eval_shape(
        lambda: init_params(jcfg, jax.random.PRNGKey(0), jbatch, hubert_cfg=hub))
    rng = np.random.default_rng(1)
    g_params, d_params = (jax.tree.map(lambda s: _draw(rng, s.shape), t)
                          for t in (g_shapes, d_shapes))
    key = jax.random.PRNGKey(7)
    jax_out = {}
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        state = create_train_state(jcfg, g_params, d_params)
        jax_out[name] = jax.jit(make_train_step(jcfg, dtype=dt, hubert_cfg=hub))(
            state, jbatch, key)
    j32 = {k: float(v) for k, v in jax_out["fp32"][1].items()}
    jbf = {k: float(v) for k, v in jax_out["bf16"][1].items()}

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = _jax_draws(key, batch, jcfg, jnp.bfloat16)
    port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT),
                     g_state=params_from_jax(g_params), d_state=disc_params_from_jax(d_params),
                     dtype=torch.bfloat16)
    before = {n: p.detach().clone() for n, p in port.gen.named_parameters()}
    got = {k: float(v) for k, v in port(tbatch, draws).items()}
    d_port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT),
                       g_state=params_from_jax(jax_out["bf16"][0].g_params),
                       d_state=disc_params_from_jax(d_params), dtype=torch.bfloat16)
    d_got = d_port._discriminator_step(tbatch, d_port._features(tbatch), None, None, draws,
                                       _Sections(None, d_port.device))
    d_got = {k: float(v.detach()) for k, v in d_got.items()}
    return j32, jbf, got, d_got, port, before


def _held(j32, jbf, got, d_got):
    """(name, port value) of every loss and grad norm: the D half's from
    the D half alone."""
    return [(k, d_got.get(k, got[k])) for k in sorted(j32) if k != "learning_rate"]


def test_metrics_within_rtol_of_jax_bf16(run):
    j32, jbf, got, d_got, _, _ = run
    assert set(got) == set(jbf)
    assert got["learning_rate"] == pytest.approx(jbf["learning_rate"], rel=1e-7)
    for k in sorted(jbf):
        np.testing.assert_allclose(got[k], jbf[k], rtol=RTOL, err_msg=k)
        if k in d_got:
            np.testing.assert_allclose(d_got[k], jbf[k], rtol=RTOL, err_msg=k)


def test_metrics_within_twice_jax_own_bf16_error(run):
    j32, jbf, got, d_got, _, _ = run
    for k, v in _held(j32, jbf, got, d_got):
        bound = 2 * abs(jbf[k] - j32[k]) + ATOL_SHARE * abs(jbf[k])
        assert abs(v - jbf[k]) <= bound, (k, v, jbf[k], j32[k])


def test_bf16_step_keeps_float32_state_and_trains(run):
    """Parameters, gradients and Adam moments stay float32; every trainable
    generator parameter moved, the frozen HuBERT did not."""
    _, _, got, _, port, before = run
    assert all(np.isfinite(v) for v in got.values())
    for name, p in port.gen.named_parameters():
        assert p.dtype == torch.float32, name
        if "hubert" in name.split("."):
            assert torch.equal(p, before[name]), name
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert port.g_opt.state[p]["exp_avg"].dtype == torch.float32, name
        assert not torch.equal(p, before[name]), name
