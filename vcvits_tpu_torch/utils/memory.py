"""Host-memory hygiene for long runs (the port's copy of
vcvits_tpu/utils/memory.py): glibc's malloc_trim(0) hands freed arena
memory back to the kernel, so a long run's resident set does not grow with
the fragments of its per-step host copies."""

from __future__ import annotations

import ctypes
import functools
import gc
from typing import Optional


@functools.lru_cache(maxsize=None)
def _libc() -> Optional[ctypes.CDLL]:
    """glibc, loaded once; None where there is none."""
    try:
        lib = ctypes.CDLL("libc.so.6")
        lib.malloc_trim.argtypes = [ctypes.c_size_t]
        lib.malloc_trim.restype = ctypes.c_int
    except (OSError, AttributeError):
        return None
    return lib


def trim_host_memory(collect: bool = True) -> bool:
    """gc (with `collect`) + glibc malloc_trim(0). Returns True if the trim
    ran; on a platform without glibc it does the gc alone."""
    if collect:
        gc.collect()
    lib = _libc()
    if lib is None:
        return False
    lib.malloc_trim(0)
    return True
