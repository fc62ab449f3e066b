"""The traced window: host spans from forward hooks, the profiler's device
timeline, and their reduction to busy time, device time per span, kernel
totals and the longest idle gaps.

Spans are the benchmark's own: each module that the loop names gets a
forward pre-hook that opens `record_function("bench.<label>")` and a
forward hook that closes it, and the loops open "bench.submit" and
"bench.convert_array" around their calls into the program. The profiler
mirrors each span on the device's timeline (from the start of its first
kernel to the end of its last); the device time of a span is the busy
time inside that interval. The program runs one stream at a time, so that
is the time of the span's own kernels, and it counts the kernels the port
launches through ctypes, which the profiler links to no host operation.
Busy time is the union of the device's kernel, copy and set intervals in
the traced window, so overlapping work counts once; the spans' mirrors
are not work and are left out of it. An idle gap is named by the
innermost benchmark span open on the host at its start, or "outside the
benchmark's spans" where none is (in the serving loop: the daemon's
gather and resolver threads, and the flow between `enc_p` and `dec`).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

SPAN_PREFIX = "bench."
TOP = 10


class Tracer:
    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles = []
        self.local = threading.local()
        self.prof = None
        self.t0 = self.t1 = 0.0

    def _hooks(self):
        for label, mod in self.modules.items():
            name = SPAN_PREFIX + label

            def pre(_m, _args, name=name):
                rf = torch.autograd.profiler.record_function(name)
                rf.__enter__()
                stack = getattr(self.local, "stack", None)
                if stack is None:
                    stack = self.local.stack = []
                stack.append(rf)

            def post(_m, _args, _out):
                self.local.stack.pop().__exit__(None, None, None)

            self.handles.append(mod.register_forward_pre_hook(pre))
            self.handles.append(mod.register_forward_hook(post))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._hooks()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            experimental_config=_all_threads())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        for h in self.handles:
            h.remove()
        return reduce(_raw(self.prof), self.t1 - self.t0)


def _raw(prof):
    """(name, on the device, start us, end us) of the device's work and of
    the benchmark's spans, read from the profiler's raw records (building
    its event tree takes minutes over a window of a million host
    operations)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        name = e.name()
        if on_device and e.is_user_annotation() and not name.startswith(SPAN_PREFIX):
            continue  # another range's mirror (the optimizer's step): not work
        if on_device or name.startswith(SPAN_PREFIX):
            start = e.start_ns() / 1e3
            out.append((name, on_device, start, start + e.duration_ns() / 1e3))
    return out


def _all_threads():
    """Profile the program's own threads too (the daemon's dispatcher), which
    were started before the profiler. A PyTorch without the option raises:
    without it those threads' spans would be lost unseen."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


def _merge(intervals: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Busy:
    """Busy time of sorted, disjoint intervals inside any [start, end], by
    bisection over their starts and a running sum of their lengths."""

    def __init__(self, merged: List[tuple]):
        self.merged = merged
        self.starts = [s for s, _ in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def within(self, start: float, end: float) -> float:
        lo = max(bisect.bisect_right(self.starts, start) - 1, 0)
        hi = bisect.bisect_left(self.starts, end)
        if hi <= lo:
            return 0.0
        total = self.cum[hi] - self.cum[lo]
        s0, e0 = self.merged[lo]
        total -= max(0.0, min(e0, start) - s0)      # the first one's part before start
        s1, e1 = self.merged[hi - 1]
        total -= max(0.0, e1 - max(end, s1))        # the last one's part after end
        return max(total, 0.0)


def reduce(events, window_s: float) -> dict:
    """The record a traced run's metric readers read from (name, on the
    device, start us, end us) events: window_s, busy_s, span_device_s
    {label: s}, span_count {label: n}, kernel_s {name: s}, kernel_count
    {name: n}, and the breakdown."""
    dev, spans, mirrors = [], [], []
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    span_s: Dict[str, float] = defaultdict(float)
    span_n: Dict[str, int] = defaultdict(int)
    for name, on_device, s, t in events:
        if name.startswith(SPAN_PREFIX):
            label = name[len(SPAN_PREFIX):]
            if on_device:
                mirrors.append((s, t, label))
            else:
                spans.append((s, t, label))
                span_n[label] += 1
        elif on_device:
            dev.append((s, t))
            kernel_s[name] += (t - s) / 1e6
            kernel_n[name] += 1
    merged = _merge(dev)
    busy = sum(t - s for s, t in merged) / 1e6
    inside = _Busy(merged)
    by_label: Dict[str, List[tuple]] = defaultdict(list)
    for s, t, label in mirrors:
        by_label[label].append((s, t))
    mirror_n = {label: len(ivs) for label, ivs in by_label.items()}
    for label, ivs in by_label.items():  # a span mirrored twice counts once
        span_s[label] = sum(inside.within(s, t) for s, t in _merge(ivs)) / 1e6
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gaps.append((b - a, a))
    gaps.sort(reverse=True)
    spans.sort()

    def label_at(t: float) -> str:
        best: Optional[tuple] = None
        for s, e, label in spans:
            if s > t:
                break
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, label)
        return best[1] if best else "outside the benchmark's spans"

    top_ops = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return {
        "window_s": window_s,
        "busy_s": busy,
        "span_device_s": dict(span_s),
        "span_count": dict(span_n),
        "mirror_count": mirror_n,
        "kernel_s": dict(kernel_s),
        "kernel_count": dict(kernel_n),
        "breakdown": {
            "device_ops": [[name[:120], s] for name, s in top_ops],
            "idle_gaps": [[label_at(at), us / 1e6] for us, at in gaps[:TOP]],
        },
    }
