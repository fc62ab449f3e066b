"""Latency is counted from the due time: on a schedule whose server stalls,
the requests queued behind the stall carry the wait, and the p95 is the
p95 of all requests, a missing one counting what it waited."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from benchmark import harness
from benchmark.loops import open_loop_serve as serve
from benchmark.tests.helpers import ROOT  # noqa: F401  (sys.path)


class StalledDaemon:
    """Answers each request `service` s after the later of its submission
    and the previous answer, after a first stall of `stall` s; drops the
    requests whose index is in `lost`."""

    def __init__(self, service, stall, lost=()):
        self.service, self.stall, self.lost = service, stall, set(lost)
        self.free_at = time.perf_counter() + stall
        self.n = 0
        self.timers = []

    def submit(self, *args):
        fut = Future()
        i, self.n = self.n, self.n + 1
        now = time.perf_counter()
        self.free_at = max(self.free_at, now) + self.service
        if i not in self.lost:
            t = threading.Timer(self.free_at - now, fut.set_result, (np.zeros(4, np.float32),))
            t.start()
            self.timers.append(t)
        return fut

    def reset_stats(self):
        pass

    def stats(self):
        return {"mean_batch": 1.0}


class Src:
    wav, pitch, true_len, speaker = np.zeros(4, np.float32), np.zeros(1, np.int64), 4, 0


def window(n, seconds, service, stall, lost=(), drain=0.5):
    st = serve.State()
    st.sources = [Src()] * n
    st.due = np.arange(n) * (seconds / n)
    st.daemon = StalledDaemon(service, stall, lost)
    st.noise_seed = 0
    st.batches = []
    ctx = harness.Context(ROOT, {"name": "t", "chips": 1}, {}, {},
                          {"noise_scale": 1.0, "drain_s": drain}, 1, seconds, False)
    res = serve.window(st, ctx)
    for t in st.daemon.timers:
        t.cancel()
    return res


def test_stall_is_charged_to_the_requests_behind_it():
    # 20 requests every 0.05 s, each served in 0.01 s, after a 0.5 s stall
    res = window(20, 1.0, 0.01, 0.5)
    lat = np.array(res.data["lat"])
    due = np.arange(20) * 0.05
    # request i waits for the stall's end (0.5 s) and the i + 1 answers before it
    want = np.maximum(0.5 + 0.01 * (np.arange(20) + 1) - due, 0.01)
    assert res.failed == 0 and res.completed == 20
    assert np.all(np.abs(lat - want) < 0.03), (lat, want)
    p95 = serve.end_to_end(None, res)["serve_p95_ms"]
    assert abs(p95 - np.percentile(lat, 95) * 1e3) < 1e-9
    assert abs(p95 - np.percentile(want, 95) * 1e3) < 30


def test_missing_requests_count_their_wait():
    res = window(10, 0.5, 0.01, 0.0, lost=(3, 7), drain=0.3)
    assert res.failed == 2 and res.completed == 8
    lat = res.data["lat"]
    # a lost request waited from its due time to the give-up time, 0.3 s past the close
    for i in (3, 7):
        assert abs(lat[i] - (0.5 + 0.3 - i * 0.05)) < 0.03
