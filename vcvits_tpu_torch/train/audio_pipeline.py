"""Train-time source smoothing: an STFT -> iSTFT round trip.

Counterpart of vcvits_tpu/train/audio_pipeline.py: the 16 kHz source goes
through a complex STFT (reflect pad (n_fft-hop)/2, center=False) and
straight back through an iSTFT (center=True), then is zero-padded or cut
back to its length. With `aug_rng` (a torch.Generator) one random band of
frequency bins is zeroed in between (`freq_mask`, SpecAugment); the train
step passes none, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcvits_tpu_torch.dsp.spectrogram import istft, stft_complex


def freq_mask(spec_re: torch.Tensor, spec_im: torch.Tensor,
              generator: Optional[torch.Generator] = None, mask_param: int = 80,
              band: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SpecAugment frequency masking (torchaudio's FrequencyMasking): the
    bins [f0, f0 + f) of the last axis zeroed, f uniform in [0, mask_param)
    and f0 uniform in [0, max(F - f, 1)), drawn from `generator`; `band`
    (f0, f) gives the band instead (JAX's threefry draws cannot be made in
    torch)."""
    f_bins = spec_re.shape[-1]
    if band is None:
        dev = generator.device if generator is not None else "cpu"
        f = int(torch.randint(0, mask_param, (), generator=generator, device=dev))
        f0 = int(torch.randint(0, max(f_bins - f, 1), (), generator=generator, device=dev))
    else:
        f0, f = band
    idx = torch.arange(f_bins, device=spec_re.device)
    keep = ~((idx >= f0) & (idx < f0 + f))
    return spec_re * keep, spec_im * keep


def smooth_source(x_wav: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
                  win_length: int = 2048,
                  aug_rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, T] -> [B, T]; wav' = istft(stft(wav)) zero-padded to T, with a
    frequency band masked in between when `aug_rng` is given."""
    re, im = stft_complex(x_wav, n_fft, hop_length, win_length)
    if aug_rng is not None:
        re, im = freq_mask(re, im, aug_rng)
    wav = istft(re, im, n_fft, hop_length, win_length)
    t = x_wav.shape[-1]
    out = torch.zeros_like(x_wav)
    n = min(t, wav.shape[-1])
    out[:, :n] = wav[:, :n].to(x_wav.dtype)
    return out
