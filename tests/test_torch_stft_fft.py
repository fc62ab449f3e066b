"""The host side of the FFT kernel behind K3 and K4 (csrc/stft_mel.cu).

The kernel runs only on the card; what it reads is made here, in pure
functions of ops/stft_mel.py, and held on the CPU:

* `mel_bands` packs mel_filterbank's [n_mels, F] into one contiguous band
  per filter; the bands rebuild the filterbank exactly.
* `fft_twiddles` is a float64 table that equals exp(-2 pi i k / n_fft)
  and each stage's factors to float64 rounding (1e-15).
* A NumPy model of the kernel's algorithm (pack, the Stockham schedule of
  `fft_stages` with the table's twiddles, the split step, the magnitude,
  the band sums) in float64 from fp32 samples to fp32 outputs, as the
  kernel computes, matches the plain version (`spectrogram_mel_plain`, a
  direct DFT) and JAX's `spectrogram_mel_fused` on its XLA path, with the
  tolerances the CUDA tests use: spec max |err| <= 1e-4 x max |spec|,
  log-mel <= 1e-4 absolute. The model's Stockham FFT alone matches
  np.fft.fft to 1e-12 of the largest bin (float64 butterflies).
* `check_kernel_sizes` refuses what the kernel does not take, with the
  rule in the message, and takes every configuration in configs/.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.ops.stft_pallas import spectrogram_mel_fused
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.dsp.spectrogram import _padded_window, mel_filterbank
from vcvits_tpu_torch.ops.stft_mel import (
    _TILES, MAX_MELS, bands_from_fbank, check_kernel_sizes, fft_stages, fft_twiddles,
    mel_bands, pick_tile, spectrogram_mel_plain)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (sr, n_fft, n_mels, fmin, fmax)
FILTERBANKS = {"48k 128": (48000, 2048, 128, 0.0, None),
               "48k 256": (48000, 2048, 256, 0.0, None),
               "16k 40": (16000, 1024, 40, 30.0, 7000.0)}

# (batch, samples, n_fft, hop, win, n_mels, sr, fmin, fmax)
MODEL_SETTINGS = {"48k": (2, 9000, 2048, 512, 2048, 128, 48000, 0.0, None),
                  "small": (2, 7000, 1024, 256, 800, 40, 16000, 30.0, 7000.0)}


@pytest.mark.parametrize("name", list(FILTERBANKS))
def test_bands_rebuild_filterbank(name):
    sr, n_fft, n_mels, fmin, fmax = FILTERBANKS[name]
    fbank = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    table, weights = mel_bands(sr, n_fft, n_mels, fmin, fmax)
    assert table.dtype == np.int32 and weights.dtype == np.float32
    start, length, offset = table
    rebuilt = np.zeros_like(fbank)
    for m in range(n_mels):
        rebuilt[m, start[m]:start[m] + length[m]] = weights[offset[m]:offset[m] + length[m]]
    np.testing.assert_array_equal(rebuilt, fbank)
    assert length.sum() == np.count_nonzero(fbank) == len(weights)
    assert (length > 0).all() and (start + length <= n_fft // 2 + 1).all()


def test_bands_refuse_a_split_filter():
    fbank = np.array([[0.0, 1.0, 2.0, 0.0], [0.5, 0.0, 0.5, 0.0]], np.float32)
    with pytest.raises(ValueError, match="mel filter 1 .* contiguous band"):
        bands_from_fbank(fbank)
    table, weights = bands_from_fbank(np.array([[0, 0, 3, 4], [0, 0, 0, 0]], np.float32))
    np.testing.assert_array_equal(table, [[2, 0], [2, 0], [0, 2]])
    np.testing.assert_array_equal(weights, [3, 4])


@pytest.mark.parametrize("n_fft", [64, 128, 512, 1024, 2048, 4096])
def test_twiddles_are_exp_to_float32_rounding(n_fft):
    m = n_fft // 2
    table = fft_twiddles(n_fft)
    assert table.shape == (n_fft, 2) and table.dtype == np.float64
    got = table[:, 0] + 1j * table[:, 1]
    want = np.exp(-2j * np.pi * np.arange(m) / n_fft)
    np.testing.assert_allclose(got[:m], want, rtol=0, atol=1e-15)
    row = m
    for radix, p in fft_stages(m):
        r, k = np.arange(1, radix)[:, None], np.arange(p)[None, :]
        stage = np.exp(-2j * np.pi * r * k / (p * radix)).ravel()
        np.testing.assert_allclose(got[row:row + len(stage)], stage, rtol=0, atol=1e-15)
        # the same powers of W as the split step's rows
        j = (r * k * n_fft // (p * radix)).ravel()
        w = np.where(j < m, got[j % m], -got[j % m])
        np.testing.assert_allclose(got[row:row + len(stage)], w, rtol=0, atol=1e-15)
        row += len(stage)
    assert row == n_fft - 1 and not table[row:].any()


def _stockham(z: np.ndarray, n_fft: int) -> np.ndarray:
    """The kernel's FFT of z [..., M] (complex128), stage by stage as
    csrc/stft_mel.cu:fft_stage runs it: butterfly i reads points i + r*per,
    multiplies point r by table row M + offset + (r-1)*p + (i mod p), and
    writes to (i - i mod p)*R + i mod p + r*p."""
    m = z.shape[-1]
    tw = fft_twiddles(n_fft)
    tw = tw[:, 0] + 1j * tw[:, 1]
    src, row = z.astype(np.complex128), m
    for radix, p in fft_stages(m):
        per = m // radix
        i = np.arange(per)
        k = i & (p - 1)
        v = [src[..., i + r * per] for r in range(radix)]
        v = [v[0]] + [v[r] * tw[row + (r - 1) * p + k] for r in range(1, radix)]
        if radix == 4:
            t0, t1, t2 = v[0] + v[2], v[0] - v[2], v[1] + v[3]
            t3 = -1j * (v[1] - v[3])
            out = [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
        else:
            out = [v[0] + v[1], v[0] - v[1]]
        dst = np.empty_like(src)
        j = (i - k) * radix + k
        for r in range(radix):
            dst[..., j + r * p] = out[r]
        src, row = dst, row + (radix - 1) * p
    return src


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096])
def test_stockham_schedule_is_the_fft(n_fft):
    rng = np.random.default_rng(n_fft)
    z = (rng.standard_normal((3, n_fft // 2)) + 1j * rng.standard_normal((3, n_fft // 2)))
    got = _stockham(z, n_fft)
    want = np.fft.fft(z, axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def _model(y, n_fft, hop, win, n_mels, sr, fmin, fmax, fft, clip=1e-5):
    """The kernel's algorithm in NumPy, float64 between the fp32 samples
    and the fp32 outputs: reflect pad, frames, pack with the float64
    window, an n_fft/2-point complex FFT (`fft`), the split step with the
    table's W^k, |X| with the 1e-6 floor, band sums with the fp32 weights
    over the float64 magnitudes, the log."""
    pad = (n_fft - hop) // 2
    yp = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
    nf = 1 + (yp.shape[1] - n_fft) // hop
    frames = np.stack([yp[:, f * hop:f * hop + n_fft] for f in range(nf)], axis=1)
    x = frames.astype(np.float64) * _padded_window(n_fft, win, np.float64)
    m = n_fft // 2
    zf = fft(x[..., 0::2] + 1j * x[..., 1::2], n_fft)
    tw = fft_twiddles(n_fft)
    w = np.concatenate([(tw[:m, 0] + 1j * tw[:m, 1]), [-1.0]])
    k = np.arange(m + 1)
    zk, zc = zf[..., k % m], np.conj(zf[..., (m - k) % m])
    xk = 0.5 * (zk + zc) - 0.5j * w * (zk - zc)
    spec = np.sqrt(xk.real ** 2 + xk.imag ** 2 + 1e-6)
    table, weights = mel_bands(sr, n_fft, n_mels, fmin, fmax)
    mel = np.zeros(spec.shape[:2] + (n_mels,))
    for mm, (start, length, offset) in enumerate(table.T):
        for j in range(length):  # ascending bins, as the kernel's thread sums them
            mel[..., mm] += spec[..., start + j] * np.float64(weights[offset + j])
    return spec.astype(np.float32), np.log(np.maximum(mel, clip)).astype(np.float32)


@pytest.mark.parametrize("fft", ["numpy", "stockham"])
@pytest.mark.parametrize("name", list(MODEL_SETTINGS))
def test_kernel_model_matches_plain_and_jax(name, fft):
    b, t, n_fft, hop, win, n_mels, sr, fmin, fmax = MODEL_SETTINGS[name]
    rng = np.random.default_rng(t)
    n = np.arange(t) / sr
    tone = sum(0.2 / (h + 1) * np.sin(2 * np.pi * 190.0 * (h + 1) * n) for h in range(8))
    y = (tone[None, :] + 0.02 * rng.standard_normal((b, t))).astype(np.float32)
    fn = (lambda z, _: np.fft.fft(z, axis=-1)) if fft == "numpy" else _stockham
    spec, mel = _model(y, n_fft, hop, win, n_mels, sr, fmin, fmax, fn)
    ref_spec, ref_mel = (r.numpy() for r in spectrogram_mel_plain(
        torch.from_numpy(y), n_fft, n_mels, sr, hop, win, fmin, fmax))
    jspec, jmel = (np.asarray(r) for r in spectrogram_mel_fused(
        jnp.asarray(y), n_fft, n_mels, sr, hop, win, fmin, fmax))
    for want_spec, want_mel in ((ref_spec, ref_mel), (jspec, jmel)):
        assert spec.shape == want_spec.shape and mel.shape == want_mel.shape
        np.testing.assert_allclose(spec, want_spec, rtol=0, atol=1e-4 * np.abs(want_spec).max())
        np.testing.assert_allclose(mel, want_mel, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(MODEL_SETTINGS))
def test_kernel_model_is_float64_close_to_plain(name):
    """A voiced tone that stops half way, so that many bands lie far below
    their frame's peak: the kernel's float64 arithmetic (the model, with
    its Stockham FFT) lands within 1e-6 of the plain version's float64
    direct DFT in both outputs, where fp32 butterflies err about 1e-5 and
    more in such bands."""
    b, t, n_fft, hop, win, n_mels, sr, fmin, fmax = MODEL_SETTINGS[name]
    rng = np.random.default_rng(t + 1)
    n = np.arange(t // 2) / sr
    phase = 2 * np.pi * np.cumsum(rng.uniform(100, 300) * (1 + 0.1 * np.sin(2 * np.pi * n))) / sr
    y = np.zeros((b, t), np.float32)
    y[:, :t // 2] = sum(0.25 / (h + 1) * np.sin((h + 1) * phase) for h in range(6)) \
        + 0.01 * rng.standard_normal((b, t // 2))
    spec, mel = _model(y, n_fft, hop, win, n_mels, sr, fmin, fmax, _stockham)
    ref_spec, ref_mel = (r.numpy() for r in spectrogram_mel_plain(
        torch.from_numpy(y), n_fft, n_mels, sr, hop, win, fmin, fmax))
    np.testing.assert_allclose(spec, ref_spec, rtol=0, atol=1e-6 * np.abs(ref_spec).max())
    np.testing.assert_allclose(mel, ref_mel, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_fft,win,hop,n_mels,match", [
    (1536, 1536, 512, 128, "power of two"),
    (1000, 800, 200, 40, "power of two"),
    (32, 32, 8, 8, "from 64 to 4096"),
    (8192, 8192, 2048, 128, "from 64 to 4096"),
    (2048, 2048, 512, MAX_MELS + 1, "1 to 256 mels"),
    (2048, 2048, 510, 128, "multiple of 4"),
    (1024, 1100, 256, 40, "win_length <= n_fft"),
])
def test_size_check_refuses(n_fft, win, hop, n_mels, match):
    with pytest.raises(ValueError, match=match):
        check_kernel_sizes(n_fft, win, hop, n_mels)


def test_size_check_takes_every_config():
    check_kernel_sizes(2048, 2048, 512, MAX_MELS)
    check_kernel_sizes(2048, 2048, 512)  # spec only: no mel rule
    check_kernel_sizes(64, 48, 16, 1)
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
    assert paths
    for path in paths:
        d = load_config(path).data
        check_kernel_sizes(d.filter_length, d.win_length, d.hop_length, d.n_mel_channels)


def test_pick_tile_keeps_every_sm_busy():
    # one 10 s row (945 frames at hop 512) on a 132-SM card, and the train targets
    for batch, frames in ((1, 945), (1, 937), (16, 375), (1, 3)):
        tile = pick_tile(batch, frames, 132)
        assert tile in _TILES
        assert batch * -(-frames // tile) >= min(132, batch * frames)
    assert pick_tile(16, 375, 132) == max(_TILES)
