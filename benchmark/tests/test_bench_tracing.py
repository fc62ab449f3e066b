"""The trace's reduction: busy time is the union of the device's work,
the spans' device-side mirrors are not work, a span's device time is the
busy time inside its mirror, and idle gaps are named by the host span open
at their start."""

import random
from benchmark import tracing
from benchmark.tests.helpers import ROOT  # noqa: F401  (sys.path)


def ev(name, start, end, device):
    return (name, device, start, end)


def test_reduce_counts_work_once_and_mirrors_never():
    events = [
        ev("bench.dec", 0, 85, False),        # host span (launches run ahead)
        ev("bench.dec", 10, 90, True),        # its mirror on the device
        ev("bench.dec", 10, 90, True),        # mirrored twice (another stream)
        ev("k1", 10, 40, True), ev("k1", 30, 50, True),   # overlapping work
        ev("conv", 60, 90, True),
        ev("conv", 200, 210, True),           # outside the span
    ]
    rec = tracing.reduce(events, window_s=1.0)
    assert rec["busy_s"] == (40 + 30 + 10) / 1e6
    assert rec["span_device_s"]["dec"] == (40 + 30) / 1e6
    assert rec["span_count"]["dec"] == 1
    assert rec["kernel_s"]["k1"] == 50 / 1e6 and rec["kernel_count"]["k1"] == 2
    assert rec["breakdown"]["idle_gaps"][0] == ["outside the benchmark's spans", 110 / 1e6]
    assert rec["breakdown"]["idle_gaps"][1] == ["dec", 10 / 1e6]
    assert all(not name.startswith("bench.") for name, _ in rec["breakdown"]["device_ops"])


def test_busy_within_matches_the_direct_sum():
    random.seed(3)
    iv = tracing._merge([(a, a + random.random()) for a in
                         sorted(random.random() * 100 for _ in range(300))])
    busy = tracing._Busy(iv)
    for _ in range(500):
        x, y = sorted(random.random() * 110 - 5 for _ in range(2))
        want = sum(max(0.0, min(e, y) - max(s, x)) for s, e in iv)
        assert abs(busy.within(x, y) - want) < 1e-9


def test_raw_events_of_a_host_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("bench.x"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    events = tracing._raw(prof)
    assert [e[0] for e in events] == ["bench.x"] and not events[0][1]
    assert events[0][3] > events[0][2]


def test_shares_of_the_card_are_taken_over_the_untraced_window():
    """A traced window that did half the work in the same wall time (the
    profiler's cost on the host) leaves the idle share and MFU as the
    untraced window reads them."""
    from benchmark import roofline
    from benchmark.metrics._read import idle_pct, mfu_pct

    untraced = {"flops": 2e15, "window_s": 10.0, "dtype": "bfloat16"}
    rec = {"flops": 1e15, "window_s": 10.0, "busy_s": 2.0, "untraced": untraced}
    assert abs(idle_pct(rec) - 60.0) < 1e-9          # 1 - 2 s / 1e15 * 2e15 / 10 s
    assert abs(mfu_pct(rec) - 100.0 * 2e14 / roofline.BF16_FLOPS) < 1e-9
    assert idle_pct({**rec, "untraced": {}}) is None and mfu_pct({}) is None
