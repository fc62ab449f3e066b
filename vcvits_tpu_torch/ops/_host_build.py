"""Build and load the port's host library (g++ -> shared library -> ctypes).

`csrc/host_dsp.cc` (the resampler and pYIN's Viterbi, bound by
dsp/host_dsp.py) is plain C++ for the CPU. `load_host(name)` builds it at
first use into `build/host_dsp/` under the checkout root when the library
is missing or older than its source, then loads it:

    g++ -O3 -std=c++17 -fPIC -shared -pthread -o build/host_dsp/lib<name>.so csrc/<name>.cc

A failed build or load raises RuntimeError; nothing falls back to NumPy.
This module imports no torch, so the data pipeline's worker processes,
which run the host DSP, start without it (ops/_build.py builds the CUDA
kernels).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_dsp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}


def host_lib_path(name: str) -> Path:
    return HOST_BUILD_DIR / f"lib{name}.so"


def build_host(name: str) -> float:
    """Compile `csrc/<name>.cc` with g++ if its library is missing or older
    than the source; returns the seconds it took (0.0 when current).
    Raises RuntimeError when g++ is missing or fails."""
    src, out = CSRC / f"{name}.cc", host_lib_path(name)
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return 0.0
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError(f"g++ not found: the host library {name} is built from "
                           f"{src} on first use")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = HOST_BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
    start = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - start


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `name`, built first if needed; raises when
    the build or the load fails."""
    lib = _LIBS.get(name)
    if lib is None:
        build_host(name)
        try:
            lib = ctypes.CDLL(str(host_lib_path(name)))
        except OSError as e:
            raise RuntimeError(f"cannot load {host_lib_path(name)}: {e}") from e
        _LIBS[name] = lib
    return lib
