"""The conversion paths end to end: SynthesizerSVC.infer, the flow-swap
voice_conversion and VoiceConverter, port == JAX.

A small configuration (2-layer HuBERT at width 16, inter 8 / hidden 16, the
real 8*8*4*2 upsampling at narrow width, the 1025-bin posterior) on shared
random weights, every weight non-zero. JAX's eps draw is injected into the
port (threefry cannot be reproduced in PyTorch). The host DSP copies are
held against the JAX package's functions. float32 on the CPU; waveform
atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.data.collate import alignment_unit as jax_alignment_unit
from vcvits_tpu.dsp import pitch as jax_pitch
from vcvits_tpu.dsp import pitch_shift as jax_pitch_shift
from vcvits_tpu.dsp import resample as jax_resample
from vcvits_tpu.dsp.spectrogram import stft_magnitude as jax_stft_magnitude
from vcvits_tpu.infer import VoiceConverter as JaxVoiceConverter
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth
from vcvits_tpu.utils import audio_io as jax_audio_io
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data.collate import alignment_unit
from vcvits_tpu_torch.dsp import pitch, pitch_shift, resample
from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.utils import audio_io

torch.set_num_threads(1)

HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=2,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {
    "data": {"n_speakers": 8},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 2, "hubert_channels": 16, "num_pitch": 64,
              "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1, 2]],
              "upsample_initial_channel": 32, "gin_channels": 4, "p_dropout": 0.0},
}


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.from_dict(CFG)
    jm = JaxSynth.from_config(jcfg).clone(hubert_cfg=JaxHubertConfig(**HUBERT))
    w = np.zeros((1, 2560), np.float32)
    spec = np.zeros((1, 40, 1025), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(  # the training forward creates every subtree
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, w,
        np.array([2560]), np.zeros((1, 8), np.int32), spec, np.array([40]),
        sid=np.array([1]), rng=jax.random.PRNGKey(2)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    port = VoiceConverter.from_params(Config.from_dict(CFG), params, device="cpu",
                                      hubert_cfg=HubertConfig(**HUBERT))
    return jcfg, jm, params, port


def test_infer_matches_jax(models):
    jcfg, jm, params, port = models
    rng = np.random.default_rng(1)
    b, t = 2, 7680
    wav = (rng.standard_normal((b, t)) * 0.2).astype(np.float32)
    lens = np.array([t, 5000], np.int32)
    pit = rng.integers(1, 64, (b, t // 320))
    sid = np.array([1, 6])
    key = jax.random.PRNGKey(3)
    o, y_mask, (z, z_p, m_p, logs_p) = jax.jit(lambda p: jm.apply(
        {"params": p}, wav, lens, pit, sid=sid, rng=key, method=JaxSynth.infer))(params)
    eps = np.array(jax.random.normal(key, np.asarray(m_p).shape, jnp.float32))
    got = port.gen.infer(torch.from_numpy(wav), torch.from_numpy(lens), torch.from_numpy(pit),
                         torch.from_numpy(sid), eps=torch.from_numpy(eps))
    to, tmask, (tz, tz_p, tm_p, tlogs_p) = got
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(y_mask))
    for name, a, r in (("m_p", tm_p, m_p), ("z_p", tz_p, z_p), ("z", tz, z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    assert to.shape == (b, 45 * 512, 1)
    assert np.abs(np.asarray(o)).mean() > 1e-3
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-4, rtol=0)


def test_voice_conversion_matches_jax(models):
    """The flow swap: posterior (source speaker) -> flow forward -> flow
    reverse (target speaker, K2's plain version) -> decoder (K1's)."""
    jcfg, jm, params, port = models
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal((2, 15360)) * 0.2).astype(np.float32)
    lens = np.array([30, 22], np.int32)
    src, tgt = np.array([1, 6]), np.array([4, 2])
    d = jcfg.data
    spec = np.asarray(jax_stft_magnitude(jnp.asarray(wav), d.filter_length, d.hop_length,
                                         d.win_length))
    key = jax.random.PRNGKey(4)
    o, y_mask, (z, z_p, z_hat) = jax.jit(lambda p: jm.apply(
        {"params": p}, spec, lens, src, tgt, rng=key, method=JaxSynth.voice_conversion))(params)
    eps = np.array(jax.random.normal(key, np.asarray(z).shape, jnp.float32))
    to, tmask, (tz, tz_p, tz_hat) = port.gen.voice_conversion(
        torch.from_numpy(spec), torch.from_numpy(lens), torch.from_numpy(src),
        torch.from_numpy(tgt), eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(y_mask))
    m = np.asarray(y_mask)
    for name, a, r in (("z", tz, z), ("z_p", tz_p, z_p), ("z_hat", tz_hat, z_hat)):
        np.testing.assert_allclose(a.numpy() * m, np.asarray(r) * m, atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    assert to.shape == (2, 30 * 512, 1) and np.abs(np.asarray(o)).mean() > 1e-3
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-4, rtol=0)


def test_voice_converter_flow_swap_matches_jax(models, tmp_path):
    """VoiceConverter.voice_conversion, file to file: resample to 48 kHz,
    pad, K3's spectrogram (its plain version), the flow swap, PCM_24."""
    jcfg, jm, params, port = models
    sr = 22050
    t = np.arange(int(0.45 * sr)) / sr
    tone = (0.3 * np.sin(2 * np.pi * 200.0 * t)
            + 0.05 * np.random.default_rng(5).standard_normal(len(t))).astype(np.float32)
    src = str(tmp_path / "src.wav")
    audio_io.write_wav(src, tone, sr, subtype="FLOAT")
    jvc = JaxVoiceConverter(jcfg, params, hubert_cfg=JaxHubertConfig(**HUBERT))
    ref = jvc.voice_conversion(src, str(tmp_path / "jax.wav"), 3, 5, rng_seed=2)

    wav48 = resample.resample(audio_io.read_wav(src)[0], sr, 48000)
    n_spec = -(-len(wav48) // 7680) * 7680 // 512  # padded to the 48 kHz alignment unit
    eps = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, n_spec, 8), jnp.float32))
    got = port.voice_conversion_array(wav48, 3, 5, eps=eps)
    assert got.shape == ref.shape == ((len(wav48) // 512) * 512,)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)

    out = str(tmp_path / "port.wav")
    seeded = port.voice_conversion(src, out, 3, 5, rng_seed=2)
    written, wsr = audio_io.read_wav(out)
    assert wsr == 48000 and seeded.shape == got.shape
    np.testing.assert_allclose(written, seeded, atol=2 ** -22)


def test_output_lengths_match_jax():
    """t_out = round(T * 3/512) and the float32 y_lengths cast, as JAX."""
    ls = (48000 / 512) / 16000
    lens = np.arange(0, 160001, 97, dtype=np.int32)
    ref = np.asarray((jnp.asarray(lens).astype(jnp.float32) * ls).astype(jnp.int32))
    got = (torch.from_numpy(lens).to(torch.float32) * ls).to(torch.int32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_convert_array_on_a_sine(models, tmp_path):
    jcfg, jm, params, port = models
    sr = 22050
    t = np.arange(int(0.7 * sr)) / sr
    sine = (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    path = str(tmp_path / "sine.wav")
    audio_io.write_wav(path, sine, sr, subtype="FLOAT")
    jvc = JaxVoiceConverter(jcfg, params, hubert_cfg=JaxHubertConfig(**HUBERT))

    wav, true_len, pit = port.prepare_source(path)
    jwav, jlen, jpit = jvc.prepare_source(path)
    assert true_len == jlen and wav.shape == jwav.shape
    np.testing.assert_allclose(wav, jwav, atol=1e-5)
    np.testing.assert_array_equal(pit, jpit)
    assert (pit > 1).mean() > 0.5  # the 220 Hz tone is found voiced

    got = port.convert_array(wav, pit, 3, true_len, noise_scale=0.0)
    ref = jvc.convert_array(wav, pit, 3, true_len, noise_scale=0.0)
    assert got.shape == ref.shape and len(got) > 0
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)

    # the file paths: convert writes what convert_array returns, and
    # convert_many (one-worker host prefetch) gives the same per job
    out = str(tmp_path / "out.wav")
    np.testing.assert_array_equal(port.convert(path, out, 3, noise_scale=0.0), got)
    assert audio_io.read_wav(out)[1] == 48000
    many = port.convert_many([(path, str(tmp_path / f"m{i}.wav"), sid)
                              for i, sid in enumerate((3, 5))],
                             noise_scale=0.0, collect_audio=True)
    np.testing.assert_array_equal(many[0], got)
    assert many[1].shape == got.shape and not np.array_equal(many[1], got)


def test_host_dsp_copies_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(4000).astype(np.float32) * 0.3
    for a, b in ((22050, 16000), (16000, 48000), (44100, 16000)):
        np.testing.assert_allclose(resample.resample(x, a, b),
                                   jax_resample.resample(x, a, b), atol=1e-5)
    # an octave keeps the resampler's rate pair small (2:1)
    np.testing.assert_allclose(pitch_shift.pitch_shift(x, 16000, 12),
                               jax_pitch_shift.pitch_shift(x, 16000, 12), atol=1e-5)
    f0 = pitch.estimate_pitch(x, 16000, 2048, 2048)
    np.testing.assert_array_equal(f0, jax_pitch.estimate_pitch(x, 16000, 2048, 2048))
    np.testing.assert_array_equal(pitch.coarse_f0(np.array([0, 60, 220, 1500.0])),
                                  jax_pitch.coarse_f0(np.array([0, 60, 220, 1500.0])))
    p = str(tmp_path / "a.wav")
    audio_io.write_wav(p, x, 16000, subtype="PCM_24")
    y, sr = jax_audio_io.read_wav(p)
    np.testing.assert_array_equal(audio_io.read_wav(p)[0], y)
    cfg = Config.from_dict(CFG)
    assert alignment_unit(cfg.data) == jax_alignment_unit(JaxConfig.from_dict(CFG).data) == 2560
