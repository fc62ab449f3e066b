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

The window and the filterbank are made in NumPy once and copied to each
device once (`device_table`): a copy from pageable host memory waits for
the device, which a step's every call would pay and a CUDA graph capture
refuses.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_DEVICE_TABLES: Dict[tuple, torch.Tensor] = {}


def device_table(device: torch.device, make, *key) -> torch.Tensor:
    """A table made by `make(*key)` in NumPy, copied to `device` once per
    device and key."""
    full = (str(device), make.__name__, *key)
    if full not in _DEVICE_TABLES:
        _DEVICE_TABLES[full] = torch.as_tensor(np.ascontiguousarray(make(*key)), device=device)
    return _DEVICE_TABLES[full]


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
    win = device_table(y.device, _padded_window, n_fft, win_length)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return spec.real, spec.imag


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """|STFT| with the sqrt(re^2+im^2+1e-6) floor; [B, T] -> [B, frames, F]."""
    re, im = stft_complex(y, n_fft, hop_length, win_length)
    return torch.sqrt(re * re + im * im + 1e-6)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[B, frames, n] -> [B, n + hop*(frames-1)], the frames summed where
    they overlap. F.fold (col2im) sums each sample's frames in a fixed
    order on the GPU too; an index_add there sums them with atomics, in an
    order that changes from run to run (a base.json train step then
    differed from itself: tools/torch_grad_determinism.py)."""
    _, t_frames, n = frames.shape
    total = n + hop_length * (t_frames - 1)
    return F.fold(frames.transpose(1, 2), (1, total), (1, n), stride=(1, hop_length))[:, 0, 0]


def istft(spec_re: torch.Tensor, spec_im: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int) -> torch.Tensor:
    """Inverse STFT with center=True trimming (torch.istft semantics):
    windowed overlap-add over the squared-window envelope.
    [B, frames, n_fft//2+1] -> [B, hop*(frames-1)]."""
    t_frames = spec_re.shape[1]
    win = device_table(spec_re.device, _padded_window, n_fft, win_length)
    frames = torch.fft.irfft(torch.complex(spec_re, spec_im), n=n_fft, dim=-1) * win
    wav = overlap_add(frames, hop_length)
    wsq = overlap_add((win * win).expand(1, t_frames, n_fft), hop_length)
    wav = wav / torch.clamp_min(wsq, 1e-11)
    trim = n_fft // 2
    return wav[:, trim:wav.shape[-1] - trim]


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
    fbank = device_table(spec.device, mel_filterbank, sr, n_fft, n_mels, fmin, fmax)
    return dynamic_range_compression(spec @ fbank.t())


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                    win_length: int, fmin: float = 0.0, fmax: Optional[float] = None
                    ) -> torch.Tensor:
    """Waveform [B, T] -> log-mel [B, T/hop, n_mels]."""
    spec = stft_magnitude(y, n_fft, hop_length, win_length)
    return spec_to_mel(spec, n_fft, n_mels, sr, fmin, fmax)
