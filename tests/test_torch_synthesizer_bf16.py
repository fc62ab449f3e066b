"""The conversion paths in bfloat16: SynthesizerSVC.infer and the flow-swap
voice_conversion with dtype=bfloat16, port against JAX's modules with
dtype=jnp.bfloat16, on the CPU. `infer` in bf16 is what a bf16 run's
validation computes.

The small configuration of tests/test_torch_synthesizer.py on shared
random weights (params_from_jax), drawn N(0, 1/fan_in) as in
tests/test_torch_train_step.py so the decoder's output depends on its
input (with that file's N(0, 0.2^2) weights the bf16 waveform does not
move at all between noise_scale 0 and 1). `infer` at noise_scale 0;
`voice_conversion` with JAX's posterior draw injected (float32: JAX's
float32 spectrogram and mask promote the posterior's statistics to it).
Neither side can match exactly: XLA on the CPU fuses elementwise chains
and keeps some intermediates in float32, torch rounds after every op,
and the port's no-grad WaveNets, flow (K2's plain version) and MRF (K1's)
compute in float32 on bf16-rounded inputs and weights where JAX's modules
round every conv's output to bf16. Measured with these inputs (torch
2.13, jax 0.9), port to JAX bf16 (JAX bf16 to JAX fp32):

* infer: waveform max |d| 1.95e-3 (2.14e-3); z, z_p, m_p, logs_p within
  1.10e-2 (9.8e-3) of the tensor's largest value;
* voice_conversion: waveform 2.88e-2 (2.33e-2); z, z_p, z_hat within
  1.78e-2 (1.28e-2).

The port's bf16 convolutions run on the CPU as float32 convolutions of
the bf16 operands (models/layers.py:conv_op).

Held to `WAV_ATOL` (5e-2 of an output in [-1, 1]) and `LATENT_SHARE`
(3e-2 of the largest value), and to the bound a fault cannot hide
behind: port-to-JAX-bf16 <= 2 x JAX's own bf16-to-fp32 distance, for the
waveform and each latent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_synthesizer import CFG, HUBERT
from tests.test_torch_train_step import _draw
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.dsp.spectrogram import stft_magnitude as jax_stft_magnitude
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.models.hubert import HubertConfig

torch.set_num_threads(1)

WAV_ATOL = 5e-2
LATENT_SHARE = 3e-2


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.from_dict(CFG)
    jm = {dt: JaxSynth.from_config(jcfg, dtype=dt).clone(hubert_cfg=JaxHubertConfig(**HUBERT))
          for dt in (jnp.float32, jnp.bfloat16)}
    w = np.zeros((1, 2560), np.float32)
    spec = np.zeros((1, 40, 1025), np.float32)
    shapes = jax.eval_shape(lambda: jm[jnp.float32].init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, w,
        np.array([2560]), np.zeros((1, 8), np.int32), spec, np.array([40]),
        sid=np.array([1]), rng=jax.random.PRNGKey(2)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: _draw(rng, s.shape), shapes)
    port = VoiceConverter.from_params(Config.from_dict(CFG), params, dtype=torch.bfloat16,
                                      device="cpu", hubert_cfg=HubertConfig(**HUBERT))
    return jcfg, jm, params, port


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _held(name, got, bf16, fp32, scale=1.0, tol=WAV_ATOL):
    """|got - bf16| within `tol` x `scale` and within 2 x |bf16 - fp32|."""
    err, own = np.abs(got - bf16).max(), np.abs(bf16 - fp32).max()
    assert err <= tol * scale, (name, err, scale)
    assert err <= 2 * own, (name, err, own)


def test_infer_bf16_matches_jax(models):
    jcfg, jm, params, port = models
    rng = np.random.default_rng(1)
    b, t = 2, 7680
    wav = (rng.standard_normal((b, t)) * 0.2).astype(np.float32)
    lens = np.array([t, 5000], np.int32)
    pit = rng.integers(1, 64, (b, t // 320))
    sid = np.array([1, 6])
    ref = {dt: jax.jit(lambda p, m=m: m.apply({"params": p}, wav, lens, pit, sid=sid,
                                               rng=jax.random.PRNGKey(3), noise_scale=0.0,
                                               method=JaxSynth.infer))(params)
           for dt, m in jm.items()}
    o, y_mask, latents = port.gen.infer(torch.from_numpy(wav), torch.from_numpy(lens),
                                        torch.from_numpy(pit), torch.from_numpy(sid),
                                        noise_scale=0.0)
    assert o.dtype == torch.bfloat16 and o.shape == (b, 45 * 512, 1)
    np.testing.assert_array_equal(y_mask.float().numpy(), _f32(ref[jnp.bfloat16][1]))
    _held("wav", o.float().numpy(), _f32(ref[jnp.bfloat16][0]), _f32(ref[jnp.float32][0]))
    for i, name in enumerate(("z", "z_p", "m_p", "logs_p")):
        fp32 = _f32(ref[jnp.float32][2][i])
        _held(name, latents[i].float().numpy(), _f32(ref[jnp.bfloat16][2][i]), fp32,
              np.abs(fp32).max(), LATENT_SHARE)


def test_voice_conversion_bf16_matches_jax(models):
    jcfg, jm, params, port = models
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal((2, 15360)) * 0.2).astype(np.float32)
    lens = np.array([30, 22], np.int32)
    src, tgt = np.array([1, 6]), np.array([4, 2])
    d = jcfg.data
    spec = np.asarray(jax_stft_magnitude(jnp.asarray(wav), d.filter_length, d.hop_length,
                                         d.win_length))
    key = jax.random.PRNGKey(4)
    ref = {dt: jax.jit(lambda p, m=m: m.apply({"params": p}, spec, lens, src, tgt, rng=key,
                                               method=JaxSynth.voice_conversion))(params)
           for dt, m in jm.items()}
    z_ref = ref[jnp.bfloat16][2][0]
    assert z_ref.dtype == jnp.float32
    eps = np.asarray(jax.random.normal(key, z_ref.shape, jnp.float32))
    o, y_mask, latents = port.gen.voice_conversion(
        torch.from_numpy(spec), torch.from_numpy(lens), torch.from_numpy(src),
        torch.from_numpy(tgt), eps=torch.from_numpy(eps))
    assert o.dtype == torch.bfloat16 and o.shape == (2, 30 * 512, 1)
    m = _f32(ref[jnp.bfloat16][1])
    np.testing.assert_array_equal(y_mask.float().numpy(), m)
    _held("wav", o.float().numpy(), _f32(ref[jnp.bfloat16][0]), _f32(ref[jnp.float32][0]))
    for i, name in enumerate(("z", "z_p", "z_hat")):
        fp32 = _f32(ref[jnp.float32][2][i]) * m
        _held(name, latents[i].float().numpy() * m, _f32(ref[jnp.bfloat16][2][i]) * m, fp32,
              np.abs(fp32).max(), LATENT_SHARE)
