"""Train-time source smoothing: an STFT -> iSTFT round trip.

Counterpart of vcvits_tpu/train/audio_pipeline.py:smooth_source: the 16 kHz
source goes through a complex STFT (reflect pad (n_fft-hop)/2,
center=False) and straight back through an iSTFT (center=True), then is
zero-padded or cut back to its length. The JAX package's optional
frequency masking is off in its train step and is not ported.
"""

from __future__ import annotations

import torch

from vcvits_tpu_torch.dsp.spectrogram import istft, stft_complex


def smooth_source(x_wav: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
                  win_length: int = 2048) -> torch.Tensor:
    """[B, T] -> [B, T]; wav' = istft(stft(wav)) zero-padded to T."""
    re, im = stft_complex(x_wav, n_fft, hop_length, win_length)
    wav = istft(re, im, n_fft, hop_length, win_length)
    t = x_wav.shape[-1]
    out = torch.zeros_like(x_wav)
    n = min(t, wav.shape[-1])
    out[:, :n] = wav[:, :n].to(x_wav.dtype)
    return out
