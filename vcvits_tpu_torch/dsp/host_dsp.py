"""ctypes bindings of the host DSP library (csrc/host_dsp.cc).

The resampler and pYIN's Viterbi decode in C++, built with g++ at first use
(ops/_host_build.py:load_host) and loaded from the checkout's
`build/host_dsp/`.
dsp/resample.py and dsp/pitch.py call these by default and keep their NumPy
code as the plain version, reached only with `plain=True`. There is no
quiet fallback: a failed build or load raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from vcvits_tpu_torch.ops import _host_build

LIB_NAME = "host_dsp"

_LIB: Optional[ctypes.CDLL] = None
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def library() -> ctypes.CDLL:
    """The typed library, built and loaded once a process."""
    global _LIB
    if _LIB is None:
        lib = _host_build.load_host(LIB_NAME)
        lib.hd_resample_out_len.restype = ctypes.c_int64
        lib.hd_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.hd_resample.restype = ctypes.c_int64
        lib.hd_resample.argtypes = [_FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                    _FLOAT_P, ctypes.c_int64]
        lib.hd_pyin_viterbi.restype = None
        lib.hd_pyin_viterbi.argtypes = [_DOUBLE_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                        _DOUBLE_P, ctypes.c_double, ctypes.c_double,
                                        ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
    return _LIB


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """[T] -> [ceil(T * new / orig)] float32, one row."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f"host_dsp.resample takes one row, got shape {x.shape}")
    lib = library()
    out = np.empty(lib.hd_resample_out_len(len(x), int(orig_sr), int(new_sr)), np.float32)
    got = lib.hd_resample(x.ctypes.data_as(_FLOAT_P), len(x), int(orig_sr), int(new_sr),
                          out.ctypes.data_as(_FLOAT_P), len(out))
    return out[:got]


def pyin_viterbi(log_obs: np.ndarray, n_bins: int, log_tri: np.ndarray, log_stay: float,
                 log_switch: float) -> np.ndarray:
    """The most likely state per frame of log_obs [T, 2 * n_bins] (voiced
    bins, then unvoiced) under the banded transition `log_tri` [odd width]
    -> [T] int64."""
    log_obs = np.ascontiguousarray(log_obs, dtype=np.float64)
    log_tri = np.ascontiguousarray(log_tri, dtype=np.float64)
    t = log_obs.shape[0]
    if log_obs.ndim != 2 or log_obs.shape[1] != 2 * n_bins or t == 0:
        raise ValueError(f"log_obs must be [T > 0, {2 * n_bins}], got {log_obs.shape}")
    if log_tri.ndim != 1 or len(log_tri) % 2 != 1:
        raise ValueError(f"log_tri must have an odd length, got {log_tri.shape}")
    states = np.empty(t, np.int32)
    library().hd_pyin_viterbi(log_obs.ctypes.data_as(_DOUBLE_P), t, int(n_bins), len(log_tri),
                              log_tri.ctypes.data_as(_DOUBLE_P), float(log_stay),
                              float(log_switch), states.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return states.astype(np.int64)
