"""How far fp32 STFTs land from float64 on the TTS step's own batch, on the
CPU: the log-mel target that K3 computes, where a band lies far below its
frame's peak.

    JAX_PLATFORMS=cpu python -m tests.k3_precision_reference

The batch is `chip_smoke.tts_batch` at the TTS step's shape (B 16, 8 s at
48 kHz, seed 31). Each log-mel is held to the float64 NumPy FFT of
`chip_smoke.log_mel_f64`: JAX's fp32 path (`dsp.spectrogram.stft_magnitude`
+ `spec_to_mel`, a direct DFT by fp32 matmul), `torch.stft` in fp32 with
the dense fbank product, the port's plain version (float64 sums rounded to
fp32) and a NumPy model of the kernel's float64 arithmetic
(tests/test_torch_stft_fft.py). Prints each one's largest distance, where
it is, and how many entries are more than 1e-4 off. Not a test: it runs
JAX's full-size STFT on the host (about half a minute).
"""

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
from tests.test_torch_stft_fft import _model, _stockham
from vcvits_tpu.dsp import spectrogram as jax_spectrogram
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.dsp.spectrogram import hann_window, mel_filterbank
from vcvits_tpu_torch.ops.stft_mel import spectrogram_mel_plain


def main() -> None:
    d = load_config(chip_smoke.CONFIG).data
    n_fft, hop, win, n_mels, sr = (d.filter_length, d.hop_length, d.win_length,
                                   d.n_mel_channels, d.target_sampling_rate)
    cfg = load_config(chip_smoke.CONFIG)
    y = chip_smoke.tts_batch(cfg, 16, np.random.default_rng(31), "cpu")["y_wav"]
    exact = chip_smoke.log_mel_f64(y, n_fft, hop, win, n_mels, sr).numpy()

    spec = jax_spectrogram.stft_magnitude(jnp.asarray(y.numpy()), n_fft, hop, win)
    jax_mel = np.asarray(jax_spectrogram.spec_to_mel(spec, n_fft, n_mels, sr))
    fbank = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels).T.copy())
    padded = F.pad(y[:, None, :], ((n_fft - hop) // 2,) * 2, mode="reflect")[:, 0]
    st = torch.stft(padded, n_fft, hop, n_fft, window=torch.as_tensor(hann_window(n_fft)),
                    center=False, return_complex=True)
    mag = torch.sqrt(st.real ** 2 + st.imag ** 2 + 1e-6).transpose(1, 2)
    runs = {"JAX fp32 (DFT matmul)": jax_mel,
            "torch.stft fp32": torch.log(torch.clamp_min(mag @ fbank, 1e-5)).numpy(),
            "plain version (float64 sums)": spectrogram_mel_plain(
                y, n_fft, n_mels, sr, hop, win)[1].numpy(),
            "kernel model (float64)": _model(y.numpy(), n_fft, hop, win, n_mels, sr, 0.0, None,
                                             _stockham)[1]}
    for name, mel in runs.items():
        err = np.abs(mel.astype(np.float64) - exact)
        worst = np.unravel_index(int(err.argmax()), err.shape)
        print(f"{name}: log-mel max |err| against float64 {err.max():.3e} at (row, frame, "
              f"band) {tuple(int(i) for i in worst)}; {int((err > 1e-4).sum())} of {err.size} "
              f"entries above 1e-4")


if __name__ == "__main__":
    main()
