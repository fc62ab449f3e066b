"""STFT magnitude and log-mel of waveforms in one pass: kernels K3 and K4.

K3 replaces vcvits_tpu/ops/stft_pallas.py:spectrogram_mel_fused, K4
replaces mel_spectrogram_fused in the same file. For y [B, T]: reflect-pad
(n_fft-hop)/2, frame at hop stride, windowed real DFT against the fp32
cos/sin bases of dsp/spectrogram.py:dft_basis, |S| = sqrt(re^2 + im^2 +
1e-6) and log(clamp(|S| @ fbank.T, clip)), fp32. Three instances of one
kernel, csrc/stft_mel.cu:

* `spectrogram_mel(y, ...)` -> (spec [B, NF, n_fft//2+1], log-mel [B, NF, n_mels]),
  the train step's frozen targets (K3);
* `spectrogram(y, ...)` -> spec only, voice_conversion's posterior input (K3);
* `mel_spectrogram(y, ...)` -> log-mel only, the trainer's validation mel
  and eval.mfcc (K4; no [B, NF, n_fft//2+1] spectrogram is written).

A CPU tensor goes to the plain versions (`spectrogram_mel_plain`,
`spectrogram_plain`, `mel_spectrogram_plain`: the same bases and sums in
PyTorch ops); a CUDA tensor launches csrc/stft_mel.cu once or raises.
`_build.LAUNCHES` counts K3's launches under "stft_mel" and K4's under
"mel_spectrogram". The outputs are frozen features, so there is no
backward: the wrappers raise on an input that requires grad. The kernel's
design and bound are in the source's header note.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vcvits_tpu_torch.dsp.spectrogram import dft_basis, mel_filterbank, reflect_pad
from vcvits_tpu_torch.ops import _build

# frames per block the kernel is built for
_TILES = (8, 16, 32)
SPEC_MEL, SPEC_ONLY, MEL_ONLY = 0, 1, 2


_DEVICE_TABLES: Dict[tuple, torch.Tensor] = {}


def _on_device(device: torch.device, make, *key) -> torch.Tensor:
    """A float32 table made by `make(*key)` in NumPy, copied to `device`
    once per device and key."""
    full = (str(device), make.__name__, *key)
    if full not in _DEVICE_TABLES:
        _DEVICE_TABLES[full] = torch.as_tensor(np.ascontiguousarray(make(*key)), device=device)
    return _DEVICE_TABLES[full]


def _cos_basis(n_fft: int, win_length: int) -> np.ndarray:
    return dft_basis(n_fft, win_length)[0]


def _sin_basis(n_fft: int, win_length: int) -> np.ndarray:
    return dft_basis(n_fft, win_length)[1]


def _fbank_t(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]) -> np.ndarray:
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T


def _tables(device: torch.device, n_fft: int, win_length: int, n_mels: Optional[int] = None,
            sr: int = 0, fmin: float = 0.0, fmax: Optional[float] = None):
    """(cos [n_fft, F], sin [n_fft, F], fbank [F, n_mels] or None) on `device`."""
    fbank = None if n_mels is None else _on_device(device, _fbank_t, sr, n_fft, n_mels, fmin,
                                                   fmax)
    return (_on_device(device, _cos_basis, n_fft, win_length),
            _on_device(device, _sin_basis, n_fft, win_length), fbank)


def _frames(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    return reflect_pad(y.float(), (n_fft - hop_length) // 2).unfold(-1, n_fft, hop_length)


def spectrogram_plain(y: torch.Tensor, n_fft: int, hop_length: int,
                      win_length: int) -> torch.Tensor:
    """[B, T] -> |STFT| [B, NF, n_fft//2+1] in PyTorch ops, the kernel's sums."""
    cos_b, sin_b, _ = _tables(y.device, n_fft, win_length)
    fr = _frames(y, n_fft, hop_length)
    re, im = fr @ cos_b, fr @ sin_b
    return torch.sqrt(re * re + im * im + 1e-6)


def spectrogram_mel_plain(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                          win_length: int, fmin: float = 0.0, fmax: Optional[float] = None,
                          clip_val: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] -> (spec, log-mel) in PyTorch ops, the kernel's sums."""
    _, _, fbank = _tables(y.device, n_fft, win_length, n_mels, sr, fmin, fmax)
    spec = spectrogram_plain(y, n_fft, hop_length, win_length)
    return spec, torch.log(torch.clamp_min(spec @ fbank, clip_val))


def mel_spectrogram_plain(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                          win_length: int, fmin: float = 0.0, fmax: Optional[float] = None,
                          clip_val: float = 1e-5) -> torch.Tensor:
    """[B, T] -> log-mel [B, NF, n_mels] in PyTorch ops, the kernel's sums."""
    return spectrogram_mel_plain(y, n_fft, n_mels, sr, hop_length, win_length, fmin, fmax,
                                 clip_val)[1]


def pick_tile(batch: int, frames: int, sms: int) -> int:
    """Largest frame tile that still gives each of the card's `sms` SMs a
    block, else the smallest: a larger tile reads the bases from L2 fewer
    times but leaves SMs idle on a short batch."""
    for tile in reversed(_TILES):
        if batch * -(-frames // tile) >= sms:
            return tile
    return _TILES[0]


def _lib():
    lib = _build.load("stft_mel")
    if not getattr(lib, "_vc_typed", False):
        lib.stft_mel.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                 + [ctypes.c_float, ctypes.c_void_p])
        lib.stft_mel.restype = ctypes.c_int
        lib._vc_typed = True
    return lib


def _check(y: torch.Tensor, n_fft: int, hop_length: int) -> None:
    if y.requires_grad:
        raise ValueError("stft_mel: the kernel has no backward; pass a tensor that does not "
                         "require grad (its outputs are frozen features)")
    if y.dim() != 2:
        raise ValueError(f"stft_mel: y must be [B, T], got {tuple(y.shape)}")
    pad = (n_fft - hop_length) // 2
    if pad < 0 or y.shape[1] <= pad:
        raise ValueError(f"stft_mel: need n_fft >= hop and T > (n_fft-hop)/2 = {pad} for the "
                         f"reflect pad, got T={y.shape[1]}")


def _launch(y: torch.Tensor, mode: int, n_fft: int, hop_length: int, win_length: int,
            n_mels: int = 1, sr: int = 0, fmin: float = 0.0, fmax: Optional[float] = None,
            clip_val: float = 1e-5, tile: Optional[int] = None):
    """One launch of instance `mode` -> (spec or None, mel or None); `tile`
    frames per block, by default `pick_tile`'s."""
    if y.device.type != "cuda":
        raise ValueError(f"stft_mel: unsupported device {y.device}")
    if n_fft % 4 or hop_length % 4:
        raise ValueError(f"stft_mel: no kernel build for n_fft={n_fft}, hop={hop_length} "
                         "(both must be multiples of 4)")
    b, t = y.shape
    pad = (n_fft - hop_length) // 2
    nf = 1 + (t + 2 * pad - n_fft) // hop_length
    if tile is None:
        tile = pick_tile(b, nf, torch.cuda.get_device_properties(y.device).multi_processor_count)
    with_spec, with_mel = mode != MEL_ONLY, mode != SPEC_ONLY
    cos_b, sin_b, fbank = _tables(y.device, n_fft, win_length, n_mels if with_mel else None,
                                  sr, fmin, fmax)
    lib = _lib()
    with torch.cuda.device(y.device):
        yf = y.float().contiguous()
        spec = torch.empty(b, nf, n_fft // 2 + 1, dtype=torch.float32, device=y.device) \
            if with_spec else None
        mel = torch.empty(b, nf, n_mels, dtype=torch.float32, device=y.device) \
            if with_mel else None
        err = lib.stft_mel(yf.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
                           fbank.data_ptr() if with_mel else None,
                           spec.data_ptr() if with_spec else None,
                           mel.data_ptr() if with_mel else None, b, t, n_fft, hop_length,
                           n_mels, tile, mode, clip_val,
                           torch.cuda.current_stream(y.device).cuda_stream)
        _build.check(err, "stft_mel")
        _build.LAUNCHES["mel_spectrogram" if mode == MEL_ONLY else "stft_mel"] += 1
    return spec, mel


def spectrogram_mel(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                    win_length: int, fmin: float = 0.0, fmax: Optional[float] = None,
                    clip_val: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [B, T] -> (spec [B, NF, n_fft//2+1], log-mel [B, NF, n_mels]), float32."""
    _check(y, n_fft, hop_length)
    if y.device.type == "cpu":
        return spectrogram_mel_plain(y, n_fft, n_mels, sr, hop_length, win_length, fmin, fmax,
                                     clip_val)
    return _launch(y, SPEC_MEL, n_fft, hop_length, win_length, n_mels, sr, fmin, fmax, clip_val)


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """y [B, T] -> spec [B, NF, n_fft//2+1], float32 (the spec-only instance)."""
    _check(y, n_fft, hop_length)
    if y.device.type == "cpu":
        return spectrogram_plain(y, n_fft, hop_length, win_length)
    return _launch(y, SPEC_ONLY, n_fft, hop_length, win_length)[0]


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                    win_length: int, fmin: float = 0.0, fmax: Optional[float] = None,
                    clip_val: float = 1e-5) -> torch.Tensor:
    """y [B, T] -> log-mel [B, NF, n_mels], float32 (the mel-only instance, K4)."""
    _check(y, n_fft, hop_length)
    if y.device.type == "cpu":
        return mel_spectrogram_plain(y, n_fft, n_mels, sr, hop_length, win_length, fmin, fmax,
                                     clip_val)
    return _launch(y, MEL_ONLY, n_fft, hop_length, win_length, n_mels, sr, fmin, fmax,
                   clip_val)[1]
