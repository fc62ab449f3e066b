"""F0 estimation (pYIN), coarse pitch quantization and per-formant pitch
normalisation (`normalize_pitch`, which no path calls), host-side NumPy.

The port's copy of vcvits_tpu/dsp/pitch.py: a vectorized implementation of
pYIN (Mauch & Dixon 2014) with FFT-autocorrelation difference function,
cumulative-mean-normalized difference, beta-prior thresholding with a
Boltzmann trough prior, and a banded Viterbi decode over voiced/unvoiced
pitch states. The decode runs in the port's C++ library
(csrc/host_dsp.cc through dsp/host_dsp.py, built at first use; a failed
build or load raises); the NumPy loop is its plain version, reached with
`plain=True`. It is not on the device path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy import stats as _stats

from vcvits_tpu_torch.dsp import host_dsp

# librosa.note_to_hz("C2") / ("C7") — the reference's pyin band (audio.py:38-39).
C2_HZ = 65.40639132514966
C7_HZ = 2093.004522404789


def _localmin(x: np.ndarray) -> np.ndarray:
    """Boolean mask of strict-left / non-strict-right local minima along -1."""
    mask = np.zeros_like(x, dtype=bool)
    mask[..., 1:-1] = (x[..., 1:-1] < x[..., :-2]) & (x[..., 1:-1] <= x[..., 2:])
    return mask


def _frame(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    return y[idx]


def _cmndf(
    frames: np.ndarray, frame_length: int, win_length: int, min_period: int, max_period: int
) -> np.ndarray:
    """Cumulative-mean-normalized difference function, [n_frames, n_periods]."""
    # Difference function d(tau) = e(0) + e(tau) - 2*acf(tau) via FFT.
    a = np.fft.rfft(frames, frame_length, axis=-1)
    b = np.fft.rfft(frames[:, win_length:0:-1], frame_length, axis=-1)
    acf = np.fft.irfft(a * b, frame_length, axis=-1)[:, win_length:]
    acf[np.abs(acf) < 1e-6] = 0.0

    energy = np.cumsum(frames**2, axis=-1)
    energy = energy[:, win_length:] - energy[:, :-win_length]
    energy[np.abs(energy) < 1e-6] = 0.0

    diff = energy[:, :1] + energy - 2.0 * acf

    tau = np.arange(1, max_period + 1)[None, :]
    cum_mean = np.cumsum(diff[:, 1 : max_period + 1], axis=-1) / tau
    numer = diff[:, min_period : max_period + 1]
    denom = cum_mean[:, min_period - 1 : max_period]
    return numer / (denom + np.finfo(diff.dtype).tiny)


def _parabolic_shifts(cmndf: np.ndarray) -> np.ndarray:
    """Sub-sample trough refinement (parabolic interpolation), same shape."""
    shifts = np.zeros_like(cmndf)
    num = cmndf[:, 2:] - cmndf[:, :-2]
    den = 2.0 * (2.0 * cmndf[:, 1:-1] - cmndf[:, 2:] - cmndf[:, :-2])
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(np.abs(den) > 1e-12, num / den, 0.0)
    shifts[:, 1:-1] = np.clip(s, -0.5, 0.5)
    return shifts


def pyin(
    y: np.ndarray,
    fmin: float = C2_HZ,
    fmax: float = C7_HZ,
    sr: int = 16000,
    frame_length: int = 2048,
    win_length: Optional[int] = None,
    hop_length: Optional[int] = None,
    n_thresholds: int = 100,
    beta_parameters: Tuple[float, float] = (2.0, 18.0),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    plain: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Probabilistic YIN. Returns (f0, voiced_flag, voiced_prob), NaN when unvoiced.

    Defaults mirror librosa.pyin as called by the reference
    (audio.py:37-46: frame_length=win_length config 2048, hop 320,
    center=False after external reflect padding).
    """
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    y = np.asarray(y, dtype=np.float64).reshape(-1)

    min_period = max(int(np.ceil(sr / fmax)), 1)
    max_period = min(int(np.floor(sr / fmin)), frame_length - win_length - 1)

    frames = _frame(y, frame_length, hop_length)
    n_frames = frames.shape[0]
    cmndf = _cmndf(frames, frame_length, win_length, min_period, max_period)
    shifts = _parabolic_shifts(cmndf)

    # Trough candidates.
    is_trough = _localmin(cmndf)
    is_trough[:, 0] = cmndf[:, 0] < cmndf[:, 1]

    # Threshold grid with a Beta(2, 18) prior.
    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)
    beta_probs = np.diff(_stats.beta.cdf(thresholds, *beta_parameters))

    # For every frame: troughs below each threshold, Boltzmann-weighted by rank.
    trough_vals = np.where(is_trough, cmndf, np.inf)  # [T, P]
    below = trough_vals[:, :, None] < thresholds[None, None, 1:]  # [T, P, K]
    ranks = np.cumsum(below, axis=1) - 1
    counts = below.sum(axis=1, keepdims=True)  # troughs below each threshold
    # Boltzmann pmf in closed form: pmf(k; lam, N) =
    # (1-e^-lam) e^(-lam k) / (1-e^-lam N). scipy.stats.boltzmann.pmf's
    # argument validation dominated the whole pyin call (~45% profiled);
    # ranks/counts are small ints, so evaluate via lookup tables instead.
    n_cand = ranks.shape[1]
    lam = boltzmann_parameter
    decay = np.exp(-lam * np.arange(n_cand + 1))  # e^(-lam k)
    denom = 1.0 - np.exp(-lam * np.maximum(np.arange(n_cand + 1), 1))
    prior = (1.0 - np.exp(-lam)) * decay[np.where(below, ranks, 0)] \
        / denom[np.minimum(counts, n_cand)]
    prior = np.where(below, prior, 0.0)
    probs = prior @ beta_probs  # [T, P]

    # Thresholds with no trough below: assign no_trough_prob mass to global min.
    no_trough_mass = ((~below.any(axis=1)) @ beta_probs) * no_trough_prob  # [T]
    global_min = np.argmin(trough_vals, axis=1)
    has_trough = is_trough.any(axis=1)
    probs[np.arange(n_frames), global_min] += np.where(has_trough, no_trough_mass, 0.0)
    probs = np.where(is_trough, probs, 0.0)

    # Map candidate periods to log2-spaced pitch bins.
    n_bps = int(np.ceil(1.0 / resolution))  # bins per semitone
    n_pitch_bins = int(np.floor(12 * n_bps * np.log2(fmax / fmin))) + 1
    periods = np.arange(min_period, max_period + 1, dtype=np.float64)[None, :] + shifts
    freqs = sr / np.maximum(periods, 1e-6)
    with np.errstate(divide="ignore", invalid="ignore"):
        bins = 12 * n_bps * np.log2(np.maximum(freqs, 1e-12) / fmin)
    bins = np.clip(np.round(bins).astype(np.int64), 0, n_pitch_bins - 1)

    # Observation probabilities over 2*n_pitch_bins states (voiced | unvoiced).
    obs = np.zeros((n_frames, 2 * n_pitch_bins))
    np.add.at(obs, (np.arange(n_frames)[:, None], bins), probs)
    voiced_prob = np.clip(obs[:, :n_pitch_bins].sum(axis=1), 0.0, 1.0)
    obs[:, n_pitch_bins:] = (1.0 - voiced_prob[:, None]) / n_pitch_bins

    # Banded triangular pitch-transition log-weights.
    max_semitones_per_frame = round(max_transition_rate * 12 * hop_length / sr)
    width = max_semitones_per_frame * n_bps + 1
    half = width // 2
    offsets = np.arange(-half, half + 1)
    tri = (half + 1 - np.abs(offsets)).astype(np.float64)
    tri /= tri.sum()
    tiny = np.finfo(np.float64).tiny
    log_tri = np.log(tri + tiny)
    log_stay = math.log(1.0 - switch_prob)
    log_switch = math.log(switch_prob)
    log_obs = np.log(obs + tiny)

    states = _viterbi_decode(log_obs, n_pitch_bins, log_tri, log_stay, log_switch, plain=plain)

    freq_of_bin = fmin * 2.0 ** (np.arange(n_pitch_bins) / (12.0 * n_bps))
    voiced_flag = states < n_pitch_bins
    f0 = freq_of_bin[states % n_pitch_bins]
    f0 = np.where(voiced_flag, f0, np.nan)
    return f0, voiced_flag, voiced_prob


def _viterbi_decode(
    log_obs: np.ndarray, n_pitch_bins: int, log_tri: np.ndarray,
    log_stay: float, log_switch: float, plain: bool = False,
) -> np.ndarray:
    """Viterbi over the factorized (voicing x pitch-band) chain: the C++
    library's `hd_pyin_viterbi`, or with `plain=True` this NumPy loop."""
    if not plain:
        return host_dsp.pyin_viterbi(log_obs, n_pitch_bins, log_tri, log_stay, log_switch)
    n_frames = log_obs.shape[0]
    half = len(log_tri) // 2
    offsets = np.arange(-half, half + 1)
    tiny = np.finfo(np.float64).tiny
    delta = np.log(np.full(2 * n_pitch_bins, 0.0) + tiny)
    delta[n_pitch_bins:] = math.log(1.0 / n_pitch_bins)  # start unvoiced
    delta = delta + log_obs[0]
    psi_v = np.zeros((n_frames, 2 * n_pitch_bins), dtype=np.int32)

    # Precompute argmax via recomputation trick: store per-step banded argmax.
    def banded_argmax(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = d.shape[-1]
        best = np.full(n, -np.inf)
        arg = np.zeros(n, dtype=np.int32)
        for off, lw in zip(offsets, log_tri):
            cand = np.full(n, -np.inf)
            if off >= 0:
                cand[: n - off] = d[off:] + lw
            else:
                cand[-off:] = d[:off] + lw
            upd = cand > best
            src = np.clip(np.arange(n) + off, 0, n - 1)
            arg = np.where(upd, src, arg)
            best = np.maximum(best, cand)
        return best, arg

    for t in range(1, n_frames):
        dv, du = delta[:n_pitch_bins], delta[n_pitch_bins:]
        bv, av = banded_argmax(dv)
        bu, au = banded_argmax(du)
        # new voiced: from voiced (stay) or unvoiced (switch)
        from_v = bv + log_stay
        from_u = bu + log_switch
        new_v = np.maximum(from_v, from_u)
        arg_v = np.where(from_v >= from_u, av, au + n_pitch_bins)
        # new unvoiced: from unvoiced (stay) or voiced (switch)
        from_u2 = bu + log_stay
        from_v2 = bv + log_switch
        new_u = np.maximum(from_u2, from_v2)
        arg_u = np.where(from_u2 >= from_v2, au + n_pitch_bins, av)
        delta = np.concatenate([new_v, new_u]) + log_obs[t]
        psi_v[t] = np.concatenate([arg_v, arg_u])

    states = np.zeros(n_frames, dtype=np.int64)
    states[-1] = int(np.argmax(delta))
    for t in range(n_frames - 1, 0, -1):
        states[t - 1] = psi_v[t, states[t]]
    return states


def estimate_pitch(
    audio: np.ndarray,
    sr: int,
    n_fft: int,
    win_length: int,
    hop_length: int = 320,
    plain: bool = False,
) -> np.ndarray:
    """Reference audio.py:24-63: reflect-pad (n_fft-hop)/2, pyin, NaN->0.

    Returns f0 in Hz, [num_frames] float32 with num_frames = len(audio)//hop
    (for len % hop == 0) — aligned 1:1 with HuBERT's 50 Hz frames.
    `plain=True` decodes with the NumPy Viterbi instead of the C++ one.
    """
    audio = np.asarray(audio, dtype=np.float64).reshape(-1)
    pad = int((n_fft - hop_length) / 2)
    snd = np.pad(audio, (pad, pad), mode="reflect")
    f0, _, _ = pyin(
        snd,
        fmin=C2_HZ,
        fmax=C7_HZ,
        sr=sr,
        frame_length=win_length,
        win_length=win_length // 2,
        hop_length=hop_length,
        plain=plain,
    )
    return np.nan_to_num(f0, nan=0.0).astype(np.float32)


def coarse_f0(
    f0: np.ndarray, f0_min: float = 50.0, f0_max: float = 1100.0, f0_bin: int = 512
) -> np.ndarray:
    """Quantize F0 (Hz) to mel-spaced integer bins in [1, f0_bin-1].

    Exact parity with audio.py:65-76 (including round-half-to-even, which
    np.round shares with torch.round). Bin 1 doubles as "unvoiced".
    """
    f0 = np.asarray(f0, dtype=np.float32)
    f0_mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1.0
    f0_mel = np.where(f0_mel > 0.0, scaled, f0_mel)
    f0_mel = np.where(f0_mel <= 1.0, 1.0, f0_mel)
    f0_mel = np.where(f0_mel > f0_bin - 1, float(f0_bin - 1), f0_mel)
    out = np.round(f0_mel).astype(np.int64)
    assert out.max(initial=1) < f0_bin and out.min(initial=1) >= 1
    return out


def normalize_pitch(pitch: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Per-formant z-normalisation that keeps unvoiced zeros at zero.
    `pitch` [n_formants, T]; `mean` / `std` one value per formant."""
    pitch = np.array(pitch, dtype=np.float32, copy=True)
    mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1)
    std = np.asarray(std, dtype=np.float32).reshape(-1, 1)
    zeros = pitch == 0.0
    pitch -= mean
    pitch /= std
    pitch[zeros] = 0.0
    return pitch
