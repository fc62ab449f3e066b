"""utils/profiling.py on the CPU: `StepTimer` against JAX's on the same tick
times, `trace` writing a Chrome trace of the block, and `start_server`
answering a capture with a written trace that holds every main-thread
step that ran while its `capturing` event was set (the capture runs on
the server's thread). TTSTrainer's
steps_per_sec is held in test_torch_infer_tts.py.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from vcvits_tpu.utils import profiling as jax_profiling
from vcvits_tpu_torch.utils.profiling import StepTimer, start_server, trace


def test_step_timer_matches_jax(monkeypatch):
    ticks = [10.0, 10.5, 11.25, 11.5, 13.0, 13.1]
    out = {}
    for name, cls in (("jax", jax_profiling.StepTimer), ("port", StepTimer)):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls(ema=0.8)
        out[name] = [(timer.tick(), timer.steps_per_sec) for _ in ticks]
    assert out["port"] == out["jax"]
    assert out["port"][0] == (None, None) and out["port"][-1][1] > 0


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "run")):
        with torch.profiler.record_function("traced_block"):
            x @ x
    names = {e.get("name") for e in _events(str(tmp_path / "run" / "trace.json"))}
    assert {"traced_block", "aten::mm"} <= names


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_capture_records_the_main_thread(tmp_path):
    server = start_server(0, logdir=str(tmp_path / "captures"))
    base = f"http://127.0.0.1:{server.port}"
    got = {}
    client = threading.Thread(target=lambda: got.update(
        capture=_get(f"{base}/trace?seconds=1")))
    try:
        client.start()
        assert server.capturing.wait(timeout=60)
        got["busy"] = _get(f"{base}/trace?seconds=0.1")
        x = torch.randn(64, 64)
        inside = 0  # steps that began and ended while the capture recorded
        while client.is_alive():
            began = server.capturing.is_set()
            with torch.profiler.record_function("main_thread_step"):
                x @ x
            inside += began and server.capturing.is_set()
        client.join(timeout=60)
        assert not client.is_alive()
        assert _get(f"{base}/trace?seconds=zero")[0] == 400
        assert _get(f"{base}/other")[0] == 404
    finally:
        server.stop()
    status, body = got["capture"]
    assert status == 200 and body["seconds"] == 1.0
    assert body["path"] == str(tmp_path / "captures" / "trace_1.json")
    assert got["busy"][0] == 409
    names = [e.get("name") for e in _events(body["path"])]
    assert inside > 0 and names.count("main_thread_step") >= inside and "aten::mm" in names


def test_server_stops(tmp_path):
    server = start_server(0, logdir=str(tmp_path))
    port = server.port
    server.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?seconds=0.1", timeout=5)
