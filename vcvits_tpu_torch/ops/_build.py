"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` has a plain C interface and compiles on its own, with
no PyTorch headers, into `build/torch_kernels/lib<name>.so` under the
checkout root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>.so csrc/<name>.cu

A library is rebuilt when it is missing or older than any source in
`csrc/`. `build()` starts one nvcc per source, all at once, and waits for
them; `load(name)` builds on first use. ptxas's register and spill report
is kept beside each library as `<name>.log`.

The host library `csrc/host_dsp.cc` is built by the sibling
`ops/_host_build.py`, which imports no torch.

`LAUNCHES` counts kernel launches by kernel name: every wrapper adds one
(`count`) where it launches its kernel, and a replayed CUDA graph adds the
launches captured in it (`add`, train/graphs.py). `GRAPHS` counts the
train step's calls by how they ran: "eager", "captured", "replayed" and
"capture_failed" (train/graphs.py). Kernels launch
from several threads at once when serving (the daemon's dispatcher and
each streaming connection), so `load` builds and loads a library once per
process under a lock, and `count` adds under a lock. `device_guard` and
`current_stream` are the wrappers' host path to a launch: no device switch
when the tensor is on the current device, and the raw handle of the
current stream without building a `torch.cuda.Stream`; `aligned16` gives
the kernels' 16-byte vector loads an aligned tensor.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("mrf", "flow_coupling", "stft_mel", "fused_gate", "int8_conv",
                  "monotonic_align", "hubert_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()
GRAPHS: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count(name: str) -> None:
    """Add one launch of kernel `name` to LAUNCHES."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def add(launches: Dict[str, int]) -> None:
    """Add launches by kernel name to LAUNCHES (negative counts take back)."""
    with _COUNT_LOCK:
        LAUNCHES.update(launches)
        for name in [k for k, n in LAUNCHES.items() if n == 0]:
            del LAUNCHES[name]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ on first use")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    return newest > out.stat().st_mtime


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the stale kernel libraries in parallel; returns seconds each
    build took (0.0 where the library was current). Raises on any failure."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - start
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed: once per
    process, whichever threads ask at the same time. A failed build raises
    in every thread that asked."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(lib_path(name)))
                _LIBS[name] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: cudaError_t {err}")


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: torch.device) -> int:
    """The handle (cudaStream_t as an int) of PyTorch's current stream on
    CUDA `device`."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself where a kernel's 16-byte loads can read it, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def device_guard(device: torch.device):
    """A context that makes CUDA `device` current for a launch: a no-op when
    it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
