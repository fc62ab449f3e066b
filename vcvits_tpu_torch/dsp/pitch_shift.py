"""Semitone pitch shifting (phase vocoder + polyphase resample), host-side.

The port's copy of vcvits_tpu/dsp/pitch_shift.py: torchaudio's
pitch_shift algorithm, a time-stretch by 2^(n/12) with a phase vocoder at
hop n_fft//4, then a resample back to the original length and rate.
"""

from __future__ import annotations

import math

import numpy as np

from vcvits_tpu_torch.dsp.resample import resample


def _stft(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    win = np.hanning(n_fft + 1)[:-1]
    return np.fft.rfft(y[idx] * win, axis=-1)


def _istft(spec: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    win = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * win
    total = n_fft + hop * (len(frames) - 1)
    out = np.zeros(total)
    wsum = np.zeros(total)
    for i, fr in enumerate(frames):
        out[i * hop : i * hop + n_fft] += fr
        wsum[i * hop : i * hop + n_fft] += win * win
    out /= np.maximum(wsum, 1e-9)
    return out[n_fft // 2 : -(n_fft // 2)]


def _phase_vocoder(spec: np.ndarray, rate: float, hop: int, n_fft: int) -> np.ndarray:
    """Time-stretch STFT frames by 1/rate (standard phase accumulation)."""
    n_frames, n_bins = spec.shape
    phi_advance = hop * 2.0 * math.pi * np.arange(n_bins) / n_fft
    time_steps = np.arange(0, n_frames, rate)
    spec_pad = np.concatenate([spec, np.zeros((2, n_bins), spec.dtype)], axis=0)

    mag = np.abs(spec_pad)
    phase = np.angle(spec_pad)
    out = np.zeros((len(time_steps), n_bins), dtype=np.complex128)
    phase_acc = phase[0].copy()
    for t, step in enumerate(time_steps):
        i0 = int(step)
        frac = step - i0
        m = (1.0 - frac) * mag[i0] + frac * mag[i0 + 1]
        out[t] = m * np.exp(1j * phase_acc)
        dphi = phase[i0 + 1] - phase[i0] - phi_advance
        dphi -= 2.0 * math.pi * np.round(dphi / (2.0 * math.pi))
        phase_acc += phi_advance + dphi
    return out


def pitch_shift(
    y: np.ndarray, sr: int, n_steps: float, bins_per_octave: int = 12, n_fft: int = 512,
    plain: bool = False,
) -> np.ndarray:
    """Shift pitch by n_steps semitones, preserving duration and rate;
    `plain=True` resamples with the NumPy version."""
    if n_steps == 0:
        return np.asarray(y, dtype=np.float32)
    y = np.asarray(y, dtype=np.float64)
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    hop = n_fft // 4
    spec = _stft(y, n_fft, hop)
    stretched = _phase_vocoder(spec, rate, hop, n_fft)
    wav = _istft(stretched, n_fft, hop)
    # stretched duration ~ len(y)/rate at rate sr -> resample to undo
    shifted = resample(wav, int(round(sr / rate)), sr, plain=plain)
    if len(shifted) < len(y):
        shifted = np.pad(shifted, (0, len(y) - len(shifted)))
    return shifted[: len(y)].astype(np.float32)
