"""The port's STFT / mel front end and K3's plain version == JAX.

Seeded numpy signals through vcvits_tpu/dsp/spectrogram.py and
vcvits_tpu_torch/dsp/spectrogram.py, at the 48 kHz setting (n_fft 2048,
hop 512, 128 mels) and a small one (n_fft 64, hop 16, win 48). float32 on
the CPU. Tolerances: the port's FFT path agrees with either of JAX's
(rfft, DFT by matmul) to 1e-5 x the largest magnitude (log-mel 1e-4
abs); the port's K3 plain version sums a 2048-term DFT by
matmul where JAX's CPU path takes an FFT: spec to 1e-5 x max |spec|,
log-mel to 1e-4 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.dsp import spectrogram as J
from vcvits_tpu.ops.stft_pallas import spectrogram_mel_fused
from vcvits_tpu.train.audio_pipeline import smooth_source as jax_smooth_source
from vcvits_tpu_torch.dsp import spectrogram as P
from vcvits_tpu_torch.ops.stft_mel import spectrogram, spectrogram_mel
from vcvits_tpu_torch.train.audio_pipeline import smooth_source

torch.set_num_threads(1)

# (n_fft, hop, win, n_mels, sr, fmin, fmax, T)
SETTINGS = {"48k": (2048, 512, 2048, 128, 48000, 0.0, None, 9000),
            "small": (64, 16, 48, 10, 16000, 50.0, 7000.0, 700)}


def _signal(t, seed=0, b=2):
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * n)[None, :] + 0.1 * rng.standard_normal((b, t))
            ).astype(np.float32)


def _close(got, ref, scale_tol=1e-5, atol=None):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=atol if atol is not None else scale_tol * np.abs(ref).max())


@pytest.mark.parametrize("name", list(SETTINGS))
def test_tables_match(name):
    n_fft, _, win, n_mels, sr, fmin, fmax, _ = SETTINGS[name]
    np.testing.assert_array_equal(P.hann_window(win), J.hann_window(win))
    for a, b in zip(P.dft_basis(n_fft, win), J._dft_basis(n_fft, win)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                                  J.mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


@pytest.mark.parametrize("jax_method", ["fft", "matmul"])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_stft_and_mel_match(name, jax_method):
    """The port's FFT path against either of JAX's (rfft, DFT by matmul)."""
    n_fft, hop, win, n_mels, sr, fmin, fmax, t = SETTINGS[name]
    y = _signal(t)
    re, im = P.stft_complex(torch.from_numpy(y), n_fft, hop, win)
    jre, jim = J.stft_complex(jnp.asarray(y), n_fft, hop, win, method=jax_method)
    _close(re, jre)
    _close(im, jim)
    _close(P.stft_magnitude(torch.from_numpy(y), n_fft, hop, win),
           J.stft_magnitude(jnp.asarray(y), n_fft, hop, win, method=jax_method))
    _close(P.mel_spectrogram(torch.from_numpy(y), n_fft, n_mels, sr, hop, win, fmin, fmax),
           J.mel_spectrogram(jnp.asarray(y), n_fft, n_mels, sr, hop, win, fmin, fmax,
                             method=jax_method), atol=1e-4)
    assert re.shape[1] == P.num_frames(t, n_fft, hop)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_istft_and_smoothing_match(name):
    n_fft, hop, win, _, _, _, _, t = SETTINGS[name]
    y = _signal(t, seed=1)
    re, im = J.stft_complex(jnp.asarray(y), n_fft, hop, win)
    _close(P.istft(torch.from_numpy(np.asarray(re)), torch.from_numpy(np.asarray(im)), n_fft,
                   hop, win), J.istft(re, im, n_fft, hop, win))
    _close(smooth_source(torch.from_numpy(y), n_fft, hop, win),
           jax_smooth_source(jnp.asarray(y), n_fft, hop, win))


def test_mel_gradient_flows():
    y = torch.from_numpy(_signal(4096, seed=2)).requires_grad_()
    P.mel_spectrogram(y, 1024, 16, 48000, 256, 1024).mean().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0


@pytest.mark.parametrize("name", list(SETTINGS))
def test_k3_plain_matches_jax(name):
    """K3's wrapper on a CPU tensor (its plain version) against JAX's
    spectrogram_mel_fused, which off the TPU returns its XLA reference."""
    n_fft, hop, win, n_mels, sr, fmin, fmax, t = SETTINGS[name]
    y = _signal(t, seed=3, b=3)
    jspec, jmel = spectrogram_mel_fused(jnp.asarray(y), n_fft, n_mels, sr, hop, win, fmin, fmax)
    spec, mel = spectrogram_mel(torch.from_numpy(y), n_fft, n_mels, sr, hop, win, fmin, fmax)
    _close(spec, jspec)
    _close(mel, jmel, atol=1e-4)
    _close(spectrogram(torch.from_numpy(y), n_fft, hop, win), jspec)


def test_k3_reflects_short_rows():
    """T just above the reflect pad, and a T that is not a multiple of hop."""
    for t in (769, 1000, 1537):
        y = _signal(t, seed=t, b=1)
        jspec = J.stft_magnitude(jnp.asarray(y), 2048, 512, 2048)
        _close(spectrogram(torch.from_numpy(y), 2048, 512, 2048), jspec)
        assert jspec.shape[1] == 1 + (t + 1536 - 2048) // 512

