"""The port's host DSP library (csrc/host_dsp.cc, dsp/host_dsp.py) against
its NumPy plain versions, on the CPU (g++ builds it at first use).

* `resample`: bit-equal to the NumPy version (both sum in float64) at the
  rate pairs the pipeline uses and on a batch of rows.
* pYIN's Viterbi: the same states as the NumPy loop on the inputs of
  tests/test_native.py (and on a longer random chain), and `estimate_pitch`
  the same f0 either way.
* No quiet fallback: a source that does not compile, or a library that
  does not load, raises from `resample` and the Viterbi, where the JAX
  package's native module returns None and uses NumPy. The library loaded
  is the port's own, under build/host_dsp/, not vcvits_tpu/native's, and
  the data pipeline's modules import no torch (its worker processes
  start faster without it).
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

from vcvits_tpu_torch.dsp import host_dsp
from vcvits_tpu_torch.dsp.pitch import _viterbi_decode, estimate_pitch
from vcvits_tpu_torch.dsp.pitch_shift import pitch_shift
from vcvits_tpu_torch.dsp.resample import resample
from vcvits_tpu_torch.ops import _host_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("orig,new", [(16000, 48000), (48000, 16000), (44100, 16000),
                                      (22050, 48000), (16000, 16000)])
def test_resample_bit_equal_to_numpy(orig, new):
    y = np.random.default_rng(0).standard_normal(12345).astype(np.float32)
    got, want = resample(y, orig, new), resample(y, orig, new, plain=True)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resample_rows_and_pitch_shift_bit_equal_to_numpy():
    g = np.random.default_rng(3)
    rows = g.standard_normal((3, 4001)).astype(np.float32)
    np.testing.assert_array_equal(resample(rows, 48000, 16000),
                                  resample(rows, 48000, 16000, plain=True))
    # an octave keeps the resampler's rate pair small (2:1)
    y = (0.3 * np.sin(2 * np.pi * 220 * np.arange(8000) / 16000)).astype(np.float32)
    np.testing.assert_array_equal(pitch_shift(y, 16000, 12),
                                  pitch_shift(y, 16000, 12, plain=True))


def _tri(half):
    tri = (half + 1 - np.abs(np.arange(-half, half + 1))).astype(float)
    tri /= tri.sum()
    return np.log(tri + np.finfo(float).tiny)


@pytest.mark.parametrize("seed,t,nb,half", [(1, 80, 50, 7), (2, 400, 120, 12)])
def test_viterbi_states_equal_numpy(seed, t, nb, half):
    log_obs = np.log(np.random.default_rng(seed).random((t, 2 * nb)) + 1e-9)
    args = (log_obs, nb, _tri(half), math.log(0.99), math.log(0.01))
    got = _viterbi_decode(*args)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _viterbi_decode(*args, plain=True))


def test_estimate_pitch_equal_either_way():
    y = (0.4 * np.sin(2 * np.pi * 330 * np.arange(32000) / 16000)).astype(np.float32)
    got = estimate_pitch(y, 16000, 2048, 2048, 320)
    np.testing.assert_array_equal(got, estimate_pitch(y, 16000, 2048, 2048, 320, plain=True))
    assert np.median(got[5:-5]) == pytest.approx(330, rel=0.02)


def test_library_is_the_ports_own():
    path = _host_build.host_lib_path(host_dsp.LIB_NAME)
    assert host_dsp.library()._name == str(path)
    assert path.exists() and path.parent.name == "host_dsp" and path.parent.parent.name == "build"


def test_data_pipeline_imports_no_torch():
    code = ("import sys, vcvits_tpu_torch.data.dataset, vcvits_tpu_torch.dsp.host_dsp; "
            "sys.exit('torch' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0


@pytest.fixture
def fresh_library(tmp_path, monkeypatch):
    """The binding with nothing loaded, building from `tmp_path/csrc` into
    `tmp_path/build`."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_host_build, "CSRC", csrc)
    monkeypatch.setattr(_host_build, "HOST_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_host_build, "_LIBS", {})
    monkeypatch.setattr(host_dsp, "_LIB", None)
    return csrc


def test_failed_build_raises(fresh_library):
    (fresh_library / "host_dsp.cc").write_text("this is not C++\n")
    y = np.zeros(1000, np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        resample(y, 16000, 48000)
    log_obs = np.zeros((4, 4))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _viterbi_decode(log_obs, 2, _tri(1), math.log(0.99), math.log(0.01))
    assert not os.path.exists(_host_build.host_lib_path("host_dsp"))


def test_failed_load_raises(fresh_library):
    (fresh_library / "host_dsp.cc").write_text("// a library with no symbols\n")
    lib = _host_build.host_lib_path("host_dsp")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"not an ELF file")
    os.utime(lib, (2e9, 2e9))  # newer than the source: no rebuild
    with pytest.raises(RuntimeError, match="cannot load"):
        resample(np.zeros(1000, np.float32), 16000, 48000)
