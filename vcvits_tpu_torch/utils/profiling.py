"""Profiling hooks (the port's counterpart of vcvits_tpu/utils/profiling.py).

* `span(name, **ids)`: a context manager that marks a phase of the program
  on the profiler's timeline. While a profiler records (`trace`, a
  `start_server` capture, `cli/train.py --profile`, or any
  `torch.profiler.profile` in the process), it opens the range
  "vcvits.<name>", whose keyword values are `ids` (a request's or a
  batch's number, so that the spans of one share it; the profiler keeps
  them where it records inputs). The range is recorded beside the kernels
  on the profiler's own clock, so each device interval and each idle gap
  can be put down to the span the host was in when it launched the work.
  It is the profiler's fast range (`_RecordFunctionFast`), a function
  range and not a user annotation: the profiler draws a user annotation
  again on the device over the kernels launched directly inside it, and a
  span of the program's nested in an annotation of its caller's (a
  forward hook's `record_function`) would take those kernels from it.
  While no profiler records, it checks one flag and opens nothing. There
  is no setting: spans exist exactly when a profiler records.
* `cut_at_spans(cut)`: while the block runs on this thread, every span's
  enter and exit calls `cut.boundary` (with ("open", name, ids) and
  ("close",)) and opens no range: train/graphs.py captures the train step
  as CUDA graphs ended and begun there, and replays them between the same
  spans, so that the work of a replay is launched inside the span it had
  when the step ran eagerly.
* `trace(logdir)`: a context manager that records the block with
  torch.profiler (CPU activity, and CUDA activity when a card is present)
  and writes it into `logdir` as a Chrome trace, `trace.json`, which
  Perfetto or chrome://tracing opens.
* `StepTimer`: a host-side EMA of the step's wall time, and steps/s.
* `start_server(port)`: the counterpart of `jax.profiler.start_server`, an
  endpoint from which a trace of the running process is taken on demand:
  an HTTP server on a thread of its own, where `GET /trace?seconds=S` runs
  torch.profiler for S seconds, writes the trace into the server's
  `logdir` and answers with its path as JSON. One capture runs at a time;
  another request meanwhile gets 409. The server's `capturing` event is
  set while a capture records, so code in the process can tell which of
  its own work fell inside one. `stop()` ends the server.
"""

from __future__ import annotations

import contextlib
import http.server
import json
import os
import tempfile
import threading
import time
import urllib.parse
from typing import Iterator, List, Optional

import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

SPAN_PREFIX = "vcvits."
_NO_SPAN = contextlib.nullcontext()
# (thread id, cut) of the capture that span boundaries cut, or None
_CUT: Optional[tuple] = None


def span(name: str, **ids):
    """The profiler range "vcvits.<name>" while a profiler records (`ids`
    its keyword values), else a context that does nothing; a boundary of
    the capture under `cut_at_spans` on its thread."""
    if _CUT is not None and _CUT[0] == threading.get_ident():
        return _Boundary(_CUT[1], name, ids)
    # the module's flag is rebound when a profiler starts and stops: read
    # it through the module each call
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(SPAN_PREFIX + name, (), ids)


class _Boundary:
    """A span under `cut_at_spans`: its enter and exit are the cut's
    boundaries."""

    def __init__(self, cut, name: str, ids: dict):
        self.cut, self.name, self.ids = cut, name, ids

    def __enter__(self) -> None:
        self.cut.boundary(("open", self.name, self.ids))

    def __exit__(self, *exc) -> bool:
        self.cut.boundary(("close",))
        return False


def current_cut():
    """The cut of `cut_at_spans` running on this thread, or None."""
    return _CUT[1] if _CUT is not None and _CUT[0] == threading.get_ident() else None


@contextlib.contextmanager
def cut_at_spans(cut) -> Iterator[None]:
    """Make every span entered or left on this thread inside the block a
    boundary of `cut` (an object with `boundary(op)`). One at a time."""
    global _CUT
    if _CUT is not None:
        raise RuntimeError("spans are already cut by another capture")
    _CUT = (threading.get_ident(), cut)
    try:
        yield
    finally:
        _CUT = None


def _activities() -> List[ProfilerActivity]:
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Record the block; write `logdir`/trace.json when it ends."""
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ProfilerServer:
    """What `start_server` returns: the bound `port`, the `logdir` its
    traces go to, the `capturing` event, and `stop()`."""

    def __init__(self, port: int, logdir: str):
        self.logdir = logdir
        self.capturing = threading.Event()
        self._busy = threading.Lock()
        self._count = 0
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - the stdlib's name
                url = urllib.parse.urlparse(self.path)
                if url.path != "/trace":
                    return self._answer(404, {"error": f"no endpoint {url.path}"})
                try:
                    seconds = float(urllib.parse.parse_qs(url.query).get("seconds", ["1"])[0])
                except ValueError:
                    return self._answer(400, {"error": "seconds must be a number"})
                if not 0 < seconds <= 600:
                    return self._answer(400, {"error": "seconds must be in (0, 600]"})
                if not server._busy.acquire(blocking=False):
                    return self._answer(409, {"error": "a capture is running"})
                try:
                    path = server._capture(seconds)
                finally:
                    server._busy.release()
                self._answer(200, {"path": path, "seconds": seconds})

            def _answer(self, code: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):  # requests are not logged
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="profiler-server")
        self._thread.start()

    def _capture(self, seconds: float) -> str:
        self._count += 1
        path = os.path.join(self.logdir, f"trace_{self._count}.json")
        # started on this thread, the profiler records only this thread's
        # operators unless told to record every thread's
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        with profile(activities=_activities(), experimental_config=config) as prof:
            # set once the profiler records, cleared before it stops
            self.capturing.set()
            try:
                time.sleep(seconds)
            finally:
                self.capturing.clear()
        prof.export_chrome_trace(path)
        return path

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()


def start_server(port: int = 9999, logdir: Optional[str] = None) -> ProfilerServer:
    """Serve captures on 127.0.0.1:`port` (0 picks a free port); traces go
    into `logdir` (a new temporary directory by default)."""
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="profiles_")
    os.makedirs(logdir, exist_ok=True)
    return ProfilerServer(port, logdir)


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._avg: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns EMA step seconds (None on first)."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._avg = dt if self._avg is None else (
                self.ema * self._avg + (1 - self.ema) * dt
            )
        self._last = now
        return self._avg

    @property
    def steps_per_sec(self) -> Optional[float]:
        return None if not self._avg else 1.0 / self._avg
