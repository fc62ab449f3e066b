"""Seeded 16 kHz sources with a known F0 contour, and their coarse pitch.

The formant synthesis follows the convergence run's corpus
(tools/torch_convergence_run.py: `_formants`, `_syllable`): per speaker a
vowel space of three formants; per syllable a harmonic stack under the
formant envelope with vibrato, or a fricative noise burst, under a
raised-cosine envelope, with breath noise. Here it is vectorised over a
request's samples and made on the device from a `torch.Generator`, so a
run's few hundred sources cost well under a second of set-up. The coarse
pitch is `coarse_f0` of the drawn F0 at the 320-sample content cadence,
bin 1 where unvoiced: the host pitch tracker is bypassed, and the same
inputs go to the program and to the reference.

`coarse_f0` is a frozen copy of vcvits_tpu_torch/dsp/pitch.py:coarse_f0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

SR = 16000
HOP = 320
N_HARM = 24


def coarse_f0(f0: np.ndarray, f0_min: float = 50.0, f0_max: float = 1100.0,
              f0_bin: int = 512) -> np.ndarray:
    """F0 (Hz) -> mel-spaced integer bins in [1, f0_bin - 1]; 1 is unvoiced."""
    f0 = np.asarray(f0, dtype=np.float32)
    f0_mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1.0
    f0_mel = np.where(f0_mel > 0.0, scaled, f0_mel)
    f0_mel = np.where(f0_mel <= 1.0, 1.0, f0_mel)
    f0_mel = np.where(f0_mel > f0_bin - 1, float(f0_bin - 1), f0_mel)
    return np.round(f0_mel).astype(np.int64)


@dataclass
class Source:
    wav: np.ndarray      # float32, zero-padded to the alignment unit
    pitch: np.ndarray    # int64 [len(wav) // 320]
    true_len: int
    speaker: int


def quantile_lengths(n: int, median_s: float, sigma: float, lo_s: float, hi_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """n lengths in seconds: the log-normal's quantiles at (i + 0.5) / n,
    clipped to [lo_s, hi_s], in an order drawn from rng. Every seed gets
    the same set of lengths, so the same work, in another order."""
    from statistics import NormalDist

    nd = NormalDist()
    q = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    secs = np.clip(median_s * np.exp(sigma * q), lo_s, hi_s)
    return secs[rng.permutation(n)]


def _vowels(gen: torch.Generator, device) -> torch.Tensor:
    """[4, 3, 3]: per vowel (centers, bandwidths, gains) of 3 formants."""
    u = torch.rand((2 + 4 * 3 * 3,), generator=gen, device=device, dtype=torch.float64)
    spread = 0.85 + 0.4 * u[:3]
    base = torch.tensor([500.0, 1500.0, 2500.0], device=device, dtype=torch.float64)
    v = u[2:2 + 36].view(4, 3, 3)
    centers = base * spread * (0.75 + 0.6 * v[:, 0])
    bws = 60.0 + 80.0 * v[:, 1]
    gains = 0.6 + 0.4 * v[:, 2]
    return torch.stack([centers, bws, gains], dim=1)


def synth(n: int, gen: torch.Generator, device, vowels: torch.Tensor, sr: int = SR):
    """One source of n samples at `sr` -> (wav float32 [n], f0 [n] Hz, 0
    unvoiced)."""
    f64 = torch.float64
    n_syl = max(1, int(math.ceil(n / (0.25 * sr))))
    u = torch.rand((n_syl, 6), generator=gen, device=device, dtype=f64)
    dur = 0.15 + 0.2 * u[:, 0]
    bounds = torch.cumsum(dur * sr, 0)
    bounds = bounds * (n / bounds[-1])
    starts = torch.cat([torch.zeros(1, device=device, dtype=f64), bounds[:-1]])
    t_idx = torch.arange(n, device=device, dtype=f64)
    syl = torch.clamp(torch.searchsorted(bounds, t_idx, right=True), max=n_syl - 1)
    local = (t_idx - starts[syl]) / torch.clamp_min(bounds[syl] - starts[syl], 1.0)
    env = 0.5 - 0.5 * torch.cos(2 * math.pi * local)
    voiced = (u[:, 1] > 0.2)[syl]
    f0_base = 90.0 + 160.0 * u[0, 2]
    f0 = f0_base * (1.0 + 0.15 * (u[:, 3] - 0.5))[syl]
    t = t_idx / sr
    f0 = f0 * (1.0 + 0.02 * torch.sin(2 * math.pi * (4.5 + 2.0 * u[0, 4]) * t))
    phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
    vow = vowels[(u[:, 5] * 4).long().clamp(max=3)][syl]          # [n, 3, 3]
    h = torch.arange(1, N_HARM + 1, device=device, dtype=f64)[:, None]  # [H, 1]
    fh = h * f0[None, :]
    amp = 0.08 + sum(vow[None, :, 2, j] / (1.0 + ((fh - vow[None, :, 0, j])
                                                 / vow[None, :, 1, j]) ** 2) for j in range(3))
    amp = amp / torch.sqrt(h) * (fh < 0.45 * sr)
    ph0 = 2 * math.pi * torch.rand((N_HARM, 1), generator=gen, device=device, dtype=f64)
    x = torch.sum(amp * torch.sin(h * phase[None, :] + ph0), dim=0)
    x = x / torch.clamp_min(torch.max(torch.abs(x)), 1e-6)
    noise = torch.randn((n,), generator=gen, device=device, dtype=f64)
    fric = torch.diff(noise, prepend=noise[:1]) * 0.35
    x = torch.where(voiced, x + 0.015 * noise, fric)
    wav = (0.35 * env * x).float()
    return wav, torch.where(voiced, f0, torch.zeros_like(f0))


def make_sources(secs: np.ndarray, seed: int, device, unit: int, n_speakers: int,
                 num_pitch: int) -> List[Source]:
    """A source per entry of `secs`, drawn from `seed` on `device`, padded
    to `unit` samples as the program's `prepare_source` pads, with a
    speaker drawn uniformly from n_speakers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vowels = [_vowels(gen, device) for _ in range(8)]
    spk = torch.randint(0, n_speakers, (len(secs),), generator=gen, device=device).tolist()
    out = []
    for i, s in enumerate(secs):
        n = int(round(float(s) * SR))
        wav, f0 = synth(n, gen, device, vowels[spk[i] % 8])
        padded = -(-n // unit) * unit
        w = np.zeros(padded, np.float32)
        w[:n] = wav.cpu().numpy()
        frames = np.zeros(padded // HOP, np.float32)
        f0_frames = f0[::HOP].cpu().numpy()
        frames[:len(f0_frames)] = f0_frames
        out.append(Source(w, coarse_f0(frames, f0_bin=num_pitch), n, int(spk[i])))
    return out


def make_train_batch(n_rows: int, bucket: int, lo_s: float, hi_s: float, gen: torch.Generator,
                     device, n_speakers: int, num_pitch: int, target_sr: int = 48000) -> dict:
    """A training batch as the program's collate pads one to a length
    bucket of `bucket` 16 kHz samples: per row a clip of lo_s to hi_s
    seconds (whole content frames), synthesized at the target rate, its
    16 kHz source every third sample, its coarse pitch of the drawn F0;
    rows padded with zeros (pitch with bin 1). Tensors on `device`."""
    ratio = target_sr // SR
    u = torch.rand((n_rows,), generator=gen, device=device, dtype=torch.float64).cpu().numpy()
    lens16 = ((lo_s + (hi_s - lo_s) * u) * SR).astype(np.int64) // HOP * HOP
    x = torch.zeros((n_rows, bucket), device=device)
    y = torch.zeros((n_rows, bucket * ratio), device=device)
    pitch = torch.ones((n_rows, bucket // HOP), dtype=torch.int64, device=device)
    sid = torch.randint(0, n_speakers, (n_rows,), generator=gen, device=device)
    for i, n16 in enumerate(lens16.tolist()):
        wav, f0 = synth(n16 * ratio, gen, device, _vowels(gen, device), sr=target_sr)
        y[i, :n16 * ratio] = wav
        x[i, :n16] = wav[::ratio]
        bins = coarse_f0(f0[::HOP * ratio].cpu().numpy(), f0_bin=num_pitch)
        pitch[i, :len(bins)] = torch.as_tensor(bins, device=device)
    lens = torch.as_tensor(lens16, dtype=torch.int32, device=device)
    return {"x_wav": x, "x_wav_lengths": lens, "x_pitch": pitch, "y_wav": y,
            "y_wav_lengths": lens * ratio, "sid": sid}
