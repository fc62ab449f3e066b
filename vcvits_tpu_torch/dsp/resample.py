"""Polyphase windowed-sinc resampler (host side).

The port's copy of vcvits_tpu/dsp/resample.py. The algorithm is
torchaudio's Resample: gcd-reduced rate pair, Hann-windowed sinc kernel
bank (lowpass_filter_width=6, rolloff=0.99), polyphase evaluation. Output
length = ceil(T * new / orig).

`resample` runs the port's C++ library (csrc/host_dsp.cc through
dsp/host_dsp.py, built at first use; a failed build or load raises), row
by row. Its plain version, reached with `plain=True`, is NumPy: one frame
matmul, frames [n_blocks, K] @ kernels.T [K, up] -> interleave. Both sum
in float64; their outputs are bit-equal (tests/test_torch_host_dsp.py).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from vcvits_tpu_torch.dsp import host_dsp


@functools.lru_cache(maxsize=32)
def _kernel_bank(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> Tuple[np.ndarray, int]:
    """Returns (kernels [new_freq, K], width) for gcd-reduced freqs."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    kernels = []
    for i in range(new_freq):
        t = (-i / new_freq + idx) * base_freq
        t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
        window = np.cos(t * math.pi / lowpass_filter_width / 2.0) ** 2
        t = t * math.pi
        kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
        kernels.append(kernel * window * (base_freq / orig_freq))
    return np.stack(kernels).astype(np.float64), width


def resample(x: np.ndarray, orig_sr: int, new_sr: int, plain: bool = False) -> np.ndarray:
    """[..., T] float -> [..., ceil(T*new/orig)] float32; `plain=True` runs
    the NumPy version instead of the C++ one."""
    if orig_sr == new_sr:
        return np.asarray(x, dtype=np.float32)
    # the samples as float32 in both versions, as the C interface takes them
    x = np.asarray(x, dtype=np.float32)
    if not plain:
        rows = [host_dsp.resample(r, orig_sr, new_sr) for r in x.reshape(-1, x.shape[-1])]
        return np.stack(rows).reshape(*x.shape[:-1], -1)
    g = math.gcd(orig_sr, new_sr)
    orig, new = orig_sr // g, new_sr // g
    kernels, width = _kernel_bank(orig, new)

    x = np.asarray(x, dtype=np.float64)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t = shape[-1]
    target_len = math.ceil(new * t / orig)

    n_blocks = t // orig + 1
    k = kernels.shape[1]  # 2*width + orig
    xpad = np.pad(x2, [(0, 0), (width, width + orig)])
    # frames[b, j, :] = xpad[b, j*orig : j*orig + k]
    stride = xpad.strides[-1]
    frames = np.lib.stride_tricks.as_strided(
        xpad,
        shape=(x2.shape[0], n_blocks, k),
        strides=(xpad.strides[0], orig * stride, stride),
        writeable=False,
    )
    out = frames @ kernels.T  # [B, n_blocks, new]
    out = out.reshape(x2.shape[0], -1)[:, :target_len]
    return out.reshape(*shape[:-1], target_len).astype(np.float32)
