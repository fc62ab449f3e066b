"""STFT / mel-spectrogram front end in differentiable PyTorch ops.

The port's own copy of vcvits_tpu/dsp/spectrogram.py: reflect-pad
(n_fft-hop)/2 on both ends, periodic Hann window, center=False,
|S| = sqrt(re^2 + im^2 + 1e-6), mel = log(clamp(|S| @ fbank.T, 1e-5)),
[B, T_frames, F] layout. Serves the generated slice's mel in the train
step (`mel_spectrogram`, gradients flow) and the source smoothing
(`stft_complex` -> `istft`). The frozen target spec + mel of the train
step and the spec of `voice_conversion` go through ops/stft_mel.py
(kernel K3), whose plain version is the same DFT by matmul against
`dft_basis`, with `mel_filterbank`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(dtype)


def _padded_window(n_fft: int, win_length: int, dtype=np.float32) -> np.ndarray:
    win = hann_window(win_length, np.float64)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    return win.astype(dtype)


def _frame_indices(num_frames: int, n_fft: int, hop: int) -> np.ndarray:
    return (np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]).astype(np.int64)


def num_frames(t: int, n_fft: int, hop_length: int) -> int:
    """Frames of a [.., t] signal after the (n_fft-hop)/2 reflect pad."""
    pad = (n_fft - hop_length) // 2
    return 1 + (t + 2 * pad - n_fft) // hop_length


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, T] -> [B, num_frames, n_fft] overlapping frames (no padding)."""
    return y.unfold(-1, n_fft, hop_length)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, win_length: int,
              dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis [n_fft, n_fft//2+1] (cos, -sin), built in
    float64 and stored as `dtype`."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * math.pi * np.outer(n, k) / n_fft
    win = _padded_window(n_fft, win_length, np.float64)
    cos_b = (np.cos(ang) * win[:, None]).astype(dtype)
    sin_b = (-np.sin(ang) * win[:, None]).astype(dtype)
    return cos_b, sin_b


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return y
    return F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def stft_complex(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                 pad: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real/imag STFT of [B, T] -> two [B, num_frames, n_fft//2+1] tensors."""
    if pad is None:
        pad = int((n_fft - hop_length) / 2)
    if pad < 0:
        raise ValueError(f"n_fft ({n_fft}) must be >= hop_length ({hop_length}) for the "
                         "reflect-padding scheme")
    frames = frame_signal(reflect_pad(y, pad), n_fft, hop_length)
    win = torch.as_tensor(_padded_window(n_fft, win_length), device=y.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return spec.real, spec.imag


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """|STFT| with the sqrt(re^2+im^2+1e-6) floor; [B, T] -> [B, frames, F]."""
    re, im = stft_complex(y, n_fft, hop_length, win_length)
    return torch.sqrt(re * re + im * im + 1e-6)


def istft(spec_re: torch.Tensor, spec_im: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int) -> torch.Tensor:
    """Inverse STFT with center=True trimming (torch.istft semantics):
    windowed overlap-add over the squared-window envelope.
    [B, frames, n_fft//2+1] -> [B, hop*(frames-1)]."""
    b, t_frames, _ = spec_re.shape
    win = torch.as_tensor(_padded_window(n_fft, win_length), device=spec_re.device)
    frames = torch.fft.irfft(torch.complex(spec_re, spec_im), n=n_fft, dim=-1) * win
    total = n_fft + hop_length * (t_frames - 1)
    idx = torch.as_tensor(_frame_indices(t_frames, n_fft, hop_length).reshape(-1),
                          device=spec_re.device)
    wav = torch.zeros(b, total, dtype=frames.dtype, device=frames.device)
    wav = wav.index_add(1, idx, frames.reshape(b, -1))
    wsq = torch.zeros(total, dtype=win.dtype, device=win.device)
    wsq = wsq.index_add(0, idx, (win * win).repeat(t_frames))
    wav = wav / torch.clamp_min(wsq, 1e-11)[None, :]
    trim = n_fft // 2
    return wav[:, trim:total - trim]


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalised mel filterbank [n_mels, n_fft//2+1]
    (the algorithm of librosa.filters.mel), float32."""
    if fmax is None:
        fmax = sr / 2.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asanyarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / (200.0 / 3.0))

    def mel_to_hz(m):
        m = np.asanyarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * (200.0 / 3.0))

    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, clip_val))."""
    return torch.log(torch.clamp_min(x, clip_val))


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sr: int, fmin: float = 0.0,
                fmax: Optional[float] = None) -> torch.Tensor:
    """[B, T, F] linear magnitude -> [B, T, n_mels] log-mel."""
    fbank = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), device=spec.device)
    return dynamic_range_compression(spec @ fbank.t())


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                    win_length: int, fmin: float = 0.0, fmax: Optional[float] = None
                    ) -> torch.Tensor:
    """Waveform [B, T] -> log-mel [B, T/hop, n_mels]."""
    spec = stft_magnitude(y, n_fft, hop_length, win_length)
    return spec_to_mel(spec, n_fft, n_mels, sr, fmin, fmax)
