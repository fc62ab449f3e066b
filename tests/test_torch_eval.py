"""The port's objective metrics == vcvits_tpu.eval on the same waveforms.

`_dct_matrix` and `dtw_path` are the same NumPy code: bit-equal. The MFCC
is the DCT of K4's plain log-mel (an fp32 DFT by matmul) against JAX's
rfft log-mel: atol 1e-3 on coefficients of size 1-100 (the log-mel
differences of a few 1e-6 through a 13 x 128 DCT). MCD, with and without
DTW: rtol 1e-4. The F0 metrics run the same pYIN on both sides (JAX's
Viterbi decode may take its native path): equal, at 48 kHz and through
the 16 kHz resample of `evaluate_pair`.
"""

import numpy as np
import pytest
import torch

from vcvits_tpu import eval as jeval
from vcvits_tpu_torch import eval as teval

torch.set_num_threads(1)

SR = 48000


def _pair(seconds=0.6, seed=0):
    """A voiced reference with a gliding f0, and a detuned, noisier copy."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 180 * (1 + 0.15 * t / seconds)
    ref = sum(0.3 / (h + 1) * np.sin(2 * np.pi * (h + 1) * np.cumsum(f0) / SR) for h in range(5))
    gen = sum(0.25 / (h + 1) * np.sin(2 * np.pi * (h + 1) * np.cumsum(f0 * 1.04) / SR)
              for h in range(4))
    ref = ref + 0.01 * rng.standard_normal(len(t))
    gen = gen[: len(t) - 1700] + 0.03 * rng.standard_normal(len(t) - 1700)
    return ref.astype(np.float32), gen.astype(np.float32)


def test_dct_and_dtw_match_jax():
    for n_mfcc, n_mels in ((13, 128), (20, 40)):
        np.testing.assert_array_equal(teval._dct_matrix(n_mfcc, n_mels),
                                      jeval._dct_matrix(n_mfcc, n_mels))
    cost = np.random.default_rng(3).random((17, 23))
    for got, want in zip(teval.dtw_path(cost), jeval.dtw_path(cost)):
        np.testing.assert_array_equal(got, want)


def test_mfcc_matches_jax():
    ref, _ = _pair()
    got = teval.mfcc(ref, SR, device="cpu")
    want = jeval.mfcc(ref, SR)
    assert got.shape == want.shape == (1 + (len(ref) - 512) // 512, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("use_dtw", [True, False])
def test_mcd_matches_jax(use_dtw):
    ref, gen = _pair()
    got = teval.mel_cepstral_distortion(ref, gen, SR, use_dtw=use_dtw, device="cpu")
    want = jeval.mel_cepstral_distortion(ref, gen, SR, use_dtw=use_dtw)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_f0_metrics_and_evaluate_pair_match_jax():
    ref, gen = _pair()
    got, want = teval.f0_metrics(ref, gen, SR), jeval.f0_metrics(ref, gen, SR)
    assert got == want and want["voiced_ref"] > 0
    got = teval.evaluate_pair(ref, gen, SR, pitch_sr=16000, use_dtw=False, device="cpu")
    want = jeval.evaluate_pair(ref, gen, SR, pitch_sr=16000, use_dtw=False)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert 0 <= got["voicing_f1"] <= 1
