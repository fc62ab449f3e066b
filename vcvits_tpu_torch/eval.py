"""Objective voice-conversion metrics (the port's counterpart of
vcvits_tpu/eval.py).

* MCD: mel-cepstral distortion in dB between MFCC frames (c1..c12; c0,
  the loudness term, is left out), DTW-aligned or truncated. The log-mel
  under the MFCC is the training front end's, computed on `device` by the
  mel-only kernel K4 (ops/stft_mel.py:mel_spectrogram); the DCT is NumPy.
* F0 RMSE and voicing F1: the host pYIN (dsp/pitch.py) of both clips.

DTW and pYIN run on the host, as in the JAX package. Every entry point
takes `device`: "cuda" by default, raising when no GPU is present unless
device="cpu" (the plain log-mel).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vcvits_tpu_torch.dsp.pitch import estimate_pitch
from vcvits_tpu_torch.dsp.resample import resample
from vcvits_tpu_torch.ops.stft_mel import mel_spectrogram
from vcvits_tpu_torch.utils.device import resolve_device

# 10 * sqrt(2) / ln(10): the euclidean distance of two natural-log cepstra
# in dB (the standard MCD constant)
_MCD_K = 10.0 * math.sqrt(2.0) / math.log(10.0)


def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_mfcc, n_mels] (scipy.fft.dct norm='ortho')."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    basis = np.cos(math.pi / n_mels * (n[None, :] + 0.5) * k)
    basis *= math.sqrt(2.0 / n_mels)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return basis.astype(np.float32)


def mfcc(wav: np.ndarray, sr: int, n_mfcc: int = 13, n_fft: int = 2048, hop_length: int = 512,
         win_length: int = 2048, n_mels: int = 128, device="cuda") -> np.ndarray:
    """Waveform [T] -> MFCC [frames, n_mfcc], the DCT-II of the log-mel.
    The defaults are the 48k config's front end, so MCD is measured in the
    model's own feature space."""
    dev = resolve_device(device)
    y = torch.as_tensor(np.asarray(wav, np.float32), device=dev)[None, :]
    logmel = mel_spectrogram(y, n_fft, n_mels, sr, hop_length, win_length)[0].cpu().numpy()
    return logmel @ _dct_matrix(n_mfcc, n_mels).T


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost monotonic alignment through a [T1, T2] cost matrix with
    steps (1,0), (0,1), (1,1); returns the (idx1, idx2) index arrays of
    the path from (0,0) to (T1-1, T2-1)."""
    t1, t2 = cost.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    for i in range(1, t1 + 1):
        # row j depends on row j-1 of the same i: a Python loop per row
        row, prev, c = acc[i], acc[i - 1], cost[i - 1]
        for j in range(1, t2 + 1):
            row[j] = c[j - 1] + min(prev[j], row[j - 1], prev[j - 1])
    i, j = t1, t2
    p1, p2 = [], []
    while i > 0 and j > 0:
        p1.append(i - 1)
        p2.append(j - 1)
        i, j = min(((i - 1, j), (i, j - 1), (i - 1, j - 1)),
                   key=lambda ij: acc[ij[0], ij[1]])
    return np.asarray(p1[::-1]), np.asarray(p2[::-1])


def mel_cepstral_distortion(ref_wav: np.ndarray, gen_wav: np.ndarray, sr: int,
                            n_mfcc: int = 13, use_dtw: bool = True, device="cuda",
                            **mel_kw) -> float:
    """MCD in dB between two waveforms at the same rate. Frames are
    DTW-aligned on the c1..c(n-1) euclidean cost; use_dtw=False truncates
    to the shorter clip instead (for sample-aligned clips, such as a
    conversion of the same utterance)."""
    c_ref = mfcc(ref_wav, sr, n_mfcc=n_mfcc, device=device, **mel_kw)[:, 1:]
    c_gen = mfcc(gen_wav, sr, n_mfcc=n_mfcc, device=device, **mel_kw)[:, 1:]
    if use_dtw:
        cost = np.sqrt(((c_ref[:, None, :] - c_gen[None, :, :]) ** 2).sum(-1))
        i1, i2 = dtw_path(cost)
        d = cost[i1, i2]
    else:
        n = min(len(c_ref), len(c_gen))
        d = np.sqrt(((c_ref[:n] - c_gen[:n]) ** 2).sum(-1))
    return float(_MCD_K * d.mean())


def f0_metrics(ref_wav: np.ndarray, gen_wav: np.ndarray, sr: int, hop_length: int = 320,
               n_fft: int = 2048, win_length: int = 2048) -> Dict[str, float]:
    """Pitch accuracy between two same-rate clips by the host pYIN:
    f0_rmse_hz / f0_rmse_cents over co-voiced frames, voicing precision,
    recall and F1 (gen against ref), and the voiced frame counts. Tracks
    are cut to the shorter."""
    f0r = estimate_pitch(np.asarray(ref_wav, np.float32), sr=sr, n_fft=n_fft,
                         win_length=win_length, hop_length=hop_length)
    f0g = estimate_pitch(np.asarray(gen_wav, np.float32), sr=sr, n_fft=n_fft,
                         win_length=win_length, hop_length=hop_length)
    n = min(len(f0r), len(f0g))
    f0r, f0g = f0r[:n], f0g[:n]
    vr, vg = f0r > 0, f0g > 0
    both = vr & vg
    tp = int(both.sum())
    prec = tp / max(int(vg.sum()), 1)
    rec = tp / max(int(vr.sum()), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    out = {"voiced_ref": int(vr.sum()), "voiced_gen": int(vg.sum()),
           "voicing_precision": round(prec, 4), "voicing_recall": round(rec, 4),
           "voicing_f1": round(f1, 4)}
    if both.any():
        r, g = f0r[both], f0g[both]
        out["f0_rmse_hz"] = round(float(np.sqrt(((r - g) ** 2).mean())), 3)
        cents = 1200.0 * np.log2(g / r)
        out["f0_rmse_cents"] = round(float(np.sqrt((cents ** 2).mean())), 2)
    else:
        out["f0_rmse_hz"] = float("nan")
        out["f0_rmse_cents"] = float("nan")
    return out


def evaluate_pair(ref_wav: np.ndarray, gen_wav: np.ndarray, sr: int,
                  pitch_sr: Optional[int] = None, use_dtw: bool = True,
                  device="cuda") -> Dict[str, float]:
    """Every metric for one (reference, generated) pair at rate sr.
    `pitch_sr`: pYIN both clips at this rate instead, after resampling
    (16 kHz is the training front end's rate and about 9x cheaper than
    48 kHz); None tracks at sr."""
    metrics = {"mcd_db": round(mel_cepstral_distortion(ref_wav, gen_wav, sr, use_dtw=use_dtw,
                                                       device=device), 4)}
    if pitch_sr and pitch_sr != sr:
        ref_p = resample(np.asarray(ref_wav, np.float32), sr, pitch_sr)
        gen_p = resample(np.asarray(gen_wav, np.float32), sr, pitch_sr)
        metrics.update(f0_metrics(ref_p, gen_p, pitch_sr))
    else:
        metrics.update(f0_metrics(ref_wav, gen_wav, sr))
    metrics["seconds"] = round(len(ref_wav) / sr, 3)
    return metrics
