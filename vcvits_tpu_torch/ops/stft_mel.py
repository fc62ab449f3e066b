"""STFT magnitude and log-mel of waveforms in one pass: kernels K3 and K4.

K3 replaces vcvits_tpu/ops/stft_pallas.py:spectrogram_mel_fused, K4
replaces mel_spectrogram_fused in the same file. For y [B, T]: reflect-pad
(n_fft-hop)/2, frame at hop stride, Hann-windowed real DFT,
|S| = sqrt(re^2 + im^2 + 1e-6) and log(clamp(|S| @ fbank.T, clip)), fp32
in and out.
Three instances of one kernel, csrc/stft_mel.cu:

* `spectrogram_mel(y, ...)` -> (spec [B, NF, n_fft//2+1], log-mel [B, NF, n_mels]),
  the train step's frozen targets (K3);
* `spectrogram(y, ...)` -> spec only, voice_conversion's posterior input (K3);
* `mel_spectrogram(y, ...)` -> log-mel only, the trainer's validation mel
  and eval.mfcc (K4; no [B, NF, n_fft//2+1] spectrogram is written).

A CPU tensor goes to the plain versions (`spectrogram_mel_plain`,
`spectrogram_plain`, `mel_spectrogram_plain`: a direct DFT by matmul
against dsp/spectrogram.py:dft_basis and the dense fbank product, both in
float64 and rounded to fp32 at the end: in fp32 the 2048-term sums alone
put the log-mel 1e-4 off where a bin's energy is far below its frame's,
the limit the kernel is held to against this version); a CUDA tensor
launches csrc/stft_mel.cu once or raises. The kernel computes the
same function through a real FFT (an n_fft/2-point complex Stockham FFT
and the split step) and sums each mel filter over its band of bins only,
in float64 between its fp32 input and outputs for the same reason.
Its tables are host-side and pure, so the CPU tests hold them:
`fft_stages` (the FFT's schedule), `fft_twiddles`, `mel_bands` and
`check_kernel_sizes` (the sizes the kernel takes). `_build.LAUNCHES`
counts K3's launches under "stft_mel" and K4's under "mel_spectrogram".
The outputs are frozen features, so there is no backward: the wrappers
raise on an input that requires grad. The kernel's design and bound are in
the source's header note.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from vcvits_tpu_torch.dsp.spectrogram import (
    _padded_window, dft_basis, device_table, mel_filterbank, reflect_pad)
from vcvits_tpu_torch.ops import _build

# frames per block the kernel is built for
_TILES = (1, 2)
MAX_MELS = 256  # the kernel stages the band table in a fixed shared array
SPEC_MEL, SPEC_ONLY, MEL_ONLY = 0, 1, 2


def _cos_basis(n_fft: int, win_length: int) -> np.ndarray:
    return dft_basis(n_fft, win_length, np.float64)[0]


def _sin_basis(n_fft: int, win_length: int) -> np.ndarray:
    return dft_basis(n_fft, win_length, np.float64)[1]


def _fbank_t(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]) -> np.ndarray:
    """The fp32 filterbank the kernel reads, widened to float64."""
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T.astype(np.float64)


def _tables(device: torch.device, n_fft: int, win_length: int, n_mels: Optional[int] = None,
            sr: int = 0, fmin: float = 0.0, fmax: Optional[float] = None):
    """The plain versions' float64 (cos [n_fft, F], sin [n_fft, F], fbank
    [F, n_mels] or None) on `device`."""
    fbank = None if n_mels is None else device_table(device, _fbank_t, sr, n_fft, n_mels, fmin,
                                                   fmax)
    return (device_table(device, _cos_basis, n_fft, win_length),
            device_table(device, _sin_basis, n_fft, win_length), fbank)


def _frames(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """The fp32 samples' frames, widened to float64."""
    return reflect_pad(y.float().double(), (n_fft - hop_length) // 2).unfold(-1, n_fft,
                                                                             hop_length)


def _spectrogram64(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int) -> torch.Tensor:
    cos_b, sin_b, _ = _tables(y.device, n_fft, win_length)
    fr = _frames(y, n_fft, hop_length)
    re, im = fr @ cos_b, fr @ sin_b
    return torch.sqrt(re * re + im * im + 1e-6)


def spectrogram_plain(y: torch.Tensor, n_fft: int, hop_length: int,
                      win_length: int) -> torch.Tensor:
    """[B, T] -> |STFT| [B, NF, n_fft//2+1] fp32 in PyTorch ops: a direct DFT."""
    return _spectrogram64(y, n_fft, hop_length, win_length).float()


def spectrogram_mel_plain(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                          win_length: int, fmin: float = 0.0, fmax: Optional[float] = None,
                          clip_val: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] -> (spec, log-mel) in PyTorch ops: a direct DFT and the dense
    fbank product."""
    _, _, fbank = _tables(y.device, n_fft, win_length, n_mels, sr, fmin, fmax)
    spec = _spectrogram64(y, n_fft, hop_length, win_length)
    return spec.float(), torch.log(torch.clamp_min(spec @ fbank, clip_val)).float()


def mel_spectrogram_plain(y: torch.Tensor, n_fft: int, n_mels: int, sr: int, hop_length: int,
                          win_length: int, fmin: float = 0.0, fmax: Optional[float] = None,
                          clip_val: float = 1e-5) -> torch.Tensor:
    """[B, T] -> log-mel [B, NF, n_mels] in PyTorch ops."""
    return spectrogram_mel_plain(y, n_fft, n_mels, sr, hop_length, win_length, fmin, fmax,
                                 clip_val)[1]


def check_kernel_sizes(n_fft: int, win_length: int, hop_length: int,
                       n_mels: Optional[int] = None) -> None:
    """Raise ValueError unless the kernel takes these sizes: n_fft a power of
    two from 64 to 4096, win_length <= n_fft, hop_length a positive multiple
    of 4 no larger than n_fft and, with a mel output, 1 <= n_mels <= 256."""
    if n_fft < 64 or n_fft > 4096 or n_fft & (n_fft - 1):
        raise ValueError(f"stft_mel: the kernel takes n_fft a power of two from 64 to 4096, "
                         f"got {n_fft}")
    if not 0 < win_length <= n_fft:
        raise ValueError(f"stft_mel: the kernel takes 0 < win_length <= n_fft, got "
                         f"win_length={win_length}, n_fft={n_fft}")
    if hop_length <= 0 or hop_length % 4 or hop_length > n_fft:
        raise ValueError(f"stft_mel: the kernel takes hop_length a positive multiple of 4 no "
                         f"larger than n_fft, got {hop_length}")
    if n_mels is not None and not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"stft_mel: the kernel takes 1 to {MAX_MELS} mels, got {n_mels}")


def fft_stages(m: int) -> List[Tuple[int, int]]:
    """The kernel's Stockham schedule for an m-point complex FFT (m a power
    of two): (radix, p) per stage, p the length of the sub-transforms done
    before it; radix-4 stages, then one radix-2 stage where log2(m) is odd."""
    stages, p = [], 1
    while p * 4 <= m:
        stages.append((4, p))
        p *= 4
    if p < m:
        stages.append((2, p))
    return stages


@functools.lru_cache(maxsize=8)
def fft_twiddles(n_fft: int) -> np.ndarray:
    """The kernel's twiddle table, [n_fft, 2] float64 (re, im). Rows 0 .. n_fft/2 - 1 hold W^k = exp(-2 pi i k / n_fft), read
    by the split step at bin k. Then, for each stage (R, p) of
    `fft_stages(n_fft // 2)` in order, exp(-2 pi i r k / (p R)) =
    W^(r k n_fft / (p R)) for r = 1 .. R-1 (outer) and k = 0 .. p-1
    (inner), so that neighbouring threads of a stage read neighbouring
    entries. The last row is 0."""
    m = n_fft // 2
    parts = [np.exp(-2j * np.pi * np.arange(m) / n_fft)]
    for radix, p in fft_stages(m):
        r, k = np.arange(1, radix)[:, None], np.arange(p)[None, :]
        parts.append(np.exp(-2j * np.pi * r * k / (p * radix)).ravel())
    table = np.zeros(n_fft, np.complex128)
    flat = np.concatenate(parts)
    table[:len(flat)] = flat
    return np.stack([table.real, table.imag], axis=-1)


def bands_from_fbank(fbank: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n_mels, F] filterbank -> (int32 [3, n_mels]: each filter's first
    non-zero bin, band length and offset into the weights; float32 weights:
    the bands' values, packed in filter order). Raises ValueError where a
    filter's non-zeros are not one contiguous run of bins; an all-zero
    filter gets length 0."""
    table = np.zeros((3, fbank.shape[0]), np.int32)
    parts, offset = [], 0
    for m, row in enumerate(fbank):
        nz = np.flatnonzero(row)
        start = int(nz[0]) if nz.size else 0
        length = int(nz[-1]) - start + 1 if nz.size else 0
        if nz.size != length:
            raise ValueError(f"stft_mel: mel filter {m} has {nz.size} non-zero bins spread over "
                             f"{length}; the kernel sums one contiguous band per filter")
        table[:, m] = start, length, offset
        parts.append(row[start:start + length])
        offset += length
    weights = np.concatenate(parts) if offset else np.zeros(1)
    return table, weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_bands(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
              fmax: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """`bands_from_fbank` of dsp/spectrogram.py:mel_filterbank."""
    return bands_from_fbank(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


def _window(n_fft: int, win_length: int) -> np.ndarray:
    """The kernel's window, float64."""
    return _padded_window(n_fft, win_length, np.float64)


def _band_table(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]):
    return mel_bands(sr, n_fft, n_mels, fmin, fmax)[0]


def _band_weights(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]):
    return mel_bands(sr, n_fft, n_mels, fmin, fmax)[1]


def pick_tile(batch: int, frames: int, sms: int) -> int:
    """Largest frame tile that still gives each of the card's `sms` SMs two
    blocks, else the smallest: a larger tile loads the overlapped samples
    of its frames once, but a short batch then leaves SMs idle. (Four
    frames a block, at half the resident warps, was the slowest on the
    H100 at every main-path shape: PERF.md.)"""
    for tile in reversed(_TILES):
        if batch * -(-frames // tile) >= 2 * sms:
            return tile
    return _TILES[0]


def _lib():
    lib = _build.load("stft_mel")
    if not getattr(lib, "_vc_typed", False):
        lib.stft_mel.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                 + [ctypes.c_double, ctypes.c_void_p])
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
    with_spec, with_mel = mode != MEL_ONLY, mode != SPEC_ONLY
    check_kernel_sizes(n_fft, win_length, hop_length, n_mels if with_mel else None)
    b, t = y.shape
    pad = (n_fft - hop_length) // 2
    nf = 1 + (t + 2 * pad - n_fft) // hop_length
    if tile is None:
        tile = pick_tile(b, nf, torch.cuda.get_device_properties(y.device).multi_processor_count)
    window = device_table(y.device, _window, n_fft, win_length)
    twiddle = device_table(y.device, fft_twiddles, n_fft)
    bands = device_table(y.device, _band_table, sr, n_fft, n_mels, fmin, fmax) if with_mel else None
    weights = (device_table(y.device, _band_weights, sr, n_fft, n_mels, fmin, fmax) if with_mel
               else None)
    lib = _lib()
    with _build.device_guard(y.device):
        yf = y.float().contiguous()
        spec = torch.empty(b, nf, n_fft // 2 + 1, dtype=torch.float32, device=y.device) \
            if with_spec else None
        mel = torch.empty(b, nf, n_mels, dtype=torch.float32, device=y.device) \
            if with_mel else None
        err = lib.stft_mel(yf.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
                           bands.data_ptr() if with_mel else None,
                           weights.data_ptr() if with_mel else None,
                           spec.data_ptr() if with_spec else None,
                           mel.data_ptr() if with_mel else None, b, t, n_fft, hop_length,
                           n_mels, tile, mode, clip_val,
                           _build.current_stream(y.device))
        _build.check(err, "stft_mel")
        _build.count("mel_spectrogram" if mode == MEL_ONLY else "stft_mel")
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
