"""ops/_build.py under threads: a kernel library is built and loaded once per
process whichever threads ask for it together, a failed build raises in
every thread that asked, and launch counts lose no update.

The serving daemon's dispatcher and each streaming connection launch
kernels from their own threads; nvcc and the library are replaced by
stand-ins here (this host has no nvcc).
"""

import collections
import sys
import threading
import time

from vcvits_tpu_torch.ops import _build

N_THREADS = 8


def _in_threads(fn):
    """Run fn in N_THREADS threads released together; (results, errors)."""
    barrier = threading.Barrier(N_THREADS)
    results, errors = [], []

    def worker():
        barrier.wait(timeout=30)
        try:
            results.append(fn())
        except RuntimeError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return results, errors


def test_load_builds_and_loads_once(monkeypatch):
    builds, loads = [], []

    def fake_build(names):
        builds.append(list(names))
        time.sleep(0.05)  # an nvcc run: the other threads arrive meanwhile
        return {n: 0.05 for n in names}

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    results, errors = _in_threads(lambda: _build.load("mrf"))
    assert not errors and len(results) == N_THREADS
    assert builds == [["mrf"]] and loads == [str(_build.lib_path("mrf"))]
    assert all(r is results[0] for r in results)
    assert _build.load("mrf") is results[0] and len(builds) == 1


def test_failed_build_raises_in_every_thread(monkeypatch):
    builds = []

    def failing_build(names):
        builds.append(list(names))
        raise RuntimeError("nvcc failed: --- mrf.cu (exit 1) ---")

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", failing_build)
    results, errors = _in_threads(lambda: _build.load("mrf"))
    assert not results and len(errors) == N_THREADS
    assert all("nvcc failed" in str(e) for e in errors)
    assert len(builds) == N_THREADS and "mrf" not in _build._LIBS  # each asked, none cached


def test_count_loses_no_update(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    per_thread = 20000

    def launches():
        for _ in range(per_thread):
            _build.count("mrf")
        return True

    results, errors = _in_threads(launches)
    assert len(results) == N_THREADS and not errors
    assert _build.LAUNCHES["mrf"] == N_THREADS * per_thread

