"""K4's plain version == JAX's mel_spectrogram_fused, and its wrapper's rules.

On the CPU, JAX's `mel_spectrogram_fused` takes its XLA path (as
tests/test_stft_pallas.py runs it): an rfft at HIGHEST precision. The
port's `mel_spectrogram_plain` is a DFT by float64 matmul against the
windowed bases, rounded to fp32. The two log-mels agree to 1e-4 absolute at the 48k
settings and at the small ones; the 2048-term sums in another order move
the log-mel by a few 1e-6 where the mel energy is well above the clip. The
wrapper takes the plain version for a CPU tensor and counts no launch,
refuses an input that requires grad, and rejects a clip no longer than
the reflect pad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.ops.stft_pallas import mel_spectrogram_fused
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.stft_mel import mel_spectrogram, mel_spectrogram_plain, spectrogram_mel

torch.set_num_threads(1)

# (batch, samples, n_fft, hop, win, n_mels, sr, fmin, fmax)
SETTINGS = {
    "48k": (1, 48000, 2048, 512, 2048, 128, 48000, 0.0, None),
    "48k short": (2, 1793, 2048, 512, 2048, 128, 48000, 0.0, None),
    "small": (2, 7000, 1024, 256, 800, 40, 16000, 30.0, 7000.0),
}


def _wave(b, t, sr, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(t) / sr
    tone = sum(0.2 / (h + 1) * np.sin(2 * np.pi * 190.0 * (h + 1) * n) for h in range(8))
    return (tone[None, :] + 0.02 * rng.standard_normal((b, t))).astype(np.float32)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_plain_matches_jax(name):
    b, t, n_fft, hop, win, n_mels, sr, fmin, fmax = SETTINGS[name]
    y = _wave(b, t, sr, t)
    want = np.asarray(mel_spectrogram_fused(jnp.asarray(y), n_fft, n_mels, sr, hop, win,
                                            fmin, fmax))
    got = mel_spectrogram_plain(torch.from_numpy(y), n_fft, n_mels, sr, hop, win, fmin, fmax)
    assert got.shape == want.shape == (b, 1 + (t - hop) // hop, n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_wrapper_takes_plain_on_cpu():
    y = torch.from_numpy(_wave(2, 9000, 48000, 1))
    _build.LAUNCHES.clear()
    got = mel_spectrogram(y, 2048, 128, 48000, 512, 2048)
    assert torch.equal(got, mel_spectrogram_plain(y, 2048, 128, 48000, 512, 2048))
    # the same sums as K3's mel
    assert torch.equal(got, spectrogram_mel(y, 2048, 128, 48000, 512, 2048)[1])
    assert sum(_build.LAUNCHES.values()) == 0


def test_wrapper_refuses_grad_and_short_input():
    with pytest.raises(ValueError, match="no backward"):
        mel_spectrogram(torch.zeros(1, 4096, requires_grad=True), 2048, 128, 48000, 512, 2048)
    with pytest.raises(ValueError, match="reflect pad"):
        mel_spectrogram(torch.zeros(1, 768), 2048, 128, 48000, 512, 2048)
