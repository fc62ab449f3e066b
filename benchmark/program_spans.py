"""The program's own spans in a traced window: where the card's work and
its idle time go, by what vcvits_tpu_torch was doing on the host.

The program marks its phases with the profiler's fast ranges
"vcvits.<name>" (vcvits_tpu_torch/utils/profiling.py:span) while a
profiler records. The profiler records them beside the kernels, on its own clock,
and links each kernel, copy and set to the runtime call that launched it
(its correlation id), with that call's thread. So:

* a piece of device work belongs to the innermost program span open on the
  thread that launched it, at its launch. A launching thread with no span
  open (autograd's device thread runs the backward's launches while the
  main thread sits in a backward section) takes the innermost span open on
  any thread then. Work the profiler links to no launch takes the span of
  its in-order neighbours on its stream: the span of both where they
  share one, else the one span that opened after the earlier one's launch
  and closed before the later one's, else the innermost span holding both;
* an idle gap (the card doing nothing between two pieces of work) belongs
  to the innermost program span open on the host at its start; where
  spans are open on two threads, to the one on the thread that launched
  the work ending the gap. The card starts work as it comes, so on the
  host's clock a gap began its own length before the launch of the work
  that ends it (the profiler's device clock sits apart from its host
  clock, and may drift: only lengths are taken from it). Where that work
  has no launch, the gap's device start is moved by the least shift that
  puts every linked piece of work after its launch;
* a span's busy time is the card's busy time (the union of its work
  intervals, overlapping work counted once) spent on work that belongs to
  it or to a span inside it, and its idle time the gaps that belong to it
  or to one inside it;
* `coverage` is the share of the busy time of work inside a program span
  that belongs to a span below the outermost (a section of
  `vcvits.train.step`, a phase of `vcvits.convert`).

On the H100 with torch 2.11 the profiler links every piece of work to its
launch, the port's ctypes kernels (through `cuLaunchKernel`) too: the
neighbour rule and the shifted gap start serve a profiler that does not.

`reduce` takes the events as (name, on the device, start us, end us,
thread, correlation id, stream) tuples; `events_of(prof)` reads them from
the middle third of a torch.profiler run's records, cut to whole steps or
requests (the readers give ms a step or a request; reading each record
costs about 4 us on the H100's host, 34 s over a traced train window's
8.8 M records). The harness's reduction (benchmark/tracing.py) keeps
no program span, so the per-layer readers of these spans (`busy_ms`,
`idle_ms`) find the traced window's profiler among their callers' locals
and reduce it once, in a second pass over its records; where the record
holds a "program" entry already, they read that. The profiler slows the
host-paced work (benchmark/metrics/_read.py:idle_pct), so the traced
window's gaps read long: `idle_ms` takes from them only each span's
share, of the untraced window's idle time.
"""

from __future__ import annotations

import bisect
import gc
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import numpy as np

from benchmark.metrics._read import idle_pct

PROGRAM = "vcvits."
BENCH = "bench."
# the CUDA API calls that put work on the card
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
HOST_OPS = ("aten::", "autograd::")
# the port's hand-written kernels, counted by span (K1, K2, K3, K5, Q1, Q2, M1)
PORT_KERNELS = ("mrf_pair_kernel", "wn_stack_kernel", "stft_mel_kernel", "gate_fwd_kernel",
                "gate_bwd_kernel", "int8_conv", "row_absmax", "mas_kernel")
OUTSIDE = "outside the spans"
TOP = 10
# the share of a traced window's records read (the middle 1/PART), and how
# far from the ends of that stretch a span must lie to be whole in it: the
# device clock sits up to about 2 ms from the host's
PART = 3
MARGIN_US = 5e4

_CACHE: Dict[int, dict] = {}


def events_of(prof, part: int = PART) -> list:
    """(name, on the device, start us, end us, thread, correlation id,
    stream) of the device work (kernels, copies, sets; not the mirrors of
    host ranges), the launching calls and the host ranges named "vcvits."
    or "bench." of the middle 1/part of a profile's records, cut to whole
    outermost program spans (`_whole`). The profiler lists its records in
    the order of their start, so that part is a stretch of the window;
    where they are not in that order, all are read."""
    records = prof.profiler.kineto_results.events()
    n = len(records)
    lo = n * (part - 1) // (2 * part)
    out = _read(records[lo:n - lo])
    starts = np.fromiter((e[2] for e in out), np.float64, len(out))
    if lo and np.any(np.diff(starts) < 0):
        lo, out = 0, _read(records)
    if not lo:
        return _whole(out, -np.inf, np.inf)
    return _whole(out, records[lo].start_ns() / 1e3 + MARGIN_US,
                  records[n - lo - 1].start_ns() / 1e3 - MARGIN_US)


def _read(records) -> list:
    """The events of `events_of` among `records`, in one pass. A record's
    name is asked first: the host operators ("aten::", "autograd::") and
    the other runtime calls, most of the records, are dropped on it, and
    only the rest is asked its device, the dearest question. The collector
    is off meanwhile: the tuples made here are millions, and no collection
    need scan them."""
    from torch.autograd import DeviceType, _KinetoEvent

    cuda = DeviceType.CUDA
    out = []
    keep = out.append
    collecting = gc.isenabled()
    gc.disable()
    try:
        for e, name in zip(records, map(_KinetoEvent.name, records)):
            if name.startswith(HOST_OPS):
                continue
            if name.startswith(LAUNCHES):
                start = e.start_ns() / 1e3
                keep((name, False, start, start, e.start_thread_id(), e.correlation_id(), 0))
            elif name.startswith("cuda"):  # another runtime call
                continue
            elif e.device_type() == cuda:
                if not e.is_user_annotation():
                    start = e.start_ns() / 1e3
                    keep((name, True, start, start + e.duration_ns() / 1e3, 0,
                          e.correlation_id(), e.device_resource_id()))
            elif name.startswith((PROGRAM, BENCH)):
                start = e.start_ns() / 1e3
                keep((name, False, start, start + e.duration_ns() / 1e3, e.start_thread_id(),
                      0, 0))
    finally:
        if collecting:
            gc.enable()
    return out


def _whole(events: list, first: float, last: float) -> list:
    """The events of the outermost program spans (those whose name no other
    range ever holds: a train step, a request) that start at `first` or
    later and end by `last`: the host ranges inside them, the launches made
    in them, the work those launched, the work no launch among `events`
    links that starts in them, and the benchmark's ranges that overlap
    them. Every event where no name is outermost."""
    ranges = sorted((e[2], -e[3], e[0]) for e in events if not e[1] and not e[5]
                    and e[0].startswith(PROGRAM))
    held, reach = set(), -np.inf
    for s, neg_end, name in ranges:
        if -neg_end <= reach:
            held.add(name)
        reach = max(reach, -neg_end)
    outer = [(s, -neg_end) for s, neg_end, name in ranges if name not in held]
    if not outer:
        return events
    inside = [(s, e) for s, e in outer if s >= first and e <= last]
    if not inside:
        return []
    t0, t1 = inside[0][0], max(e for _, e in inside)
    launched = {e[5] for e in events if not e[1] and e[5]}
    kept = {e[5] for e in events if not e[1] and e[5] and t0 <= e[2] <= t1}

    def whole(e) -> bool:
        name, on_device, start, end, _, corr, _ = e
        if on_device:
            return corr in kept if corr in launched else t0 <= start <= t1
        if name.startswith(BENCH):  # it names the gaps it holds
            return start <= t1 and end >= t0
        return t0 <= start and end <= t1

    return [e for e in events if whole(e)]


class _Spans:
    """Host ranges of one kind, their nesting on each thread, and the
    innermost one open on each thread at any time (by bisection over the
    times where that changes)."""

    def __init__(self, ranges: List[tuple]):
        # (start, end, thread, name), outer before inner where two start together
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self._by_thread: Optional[Dict[int, np.ndarray]] = None
        self._any = np.zeros(0, np.int64)
        self.parent: List[int] = []
        self.depth: List[int] = []
        stacks: Dict[int, List[int]] = defaultdict(list)
        marks = []  # (time, 0 close / 1 open, index)
        for i, (s, e, tid, _) in enumerate(self.ranges):
            stack = stacks[tid]
            while stack and self.ranges[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            self.depth.append(len(stack))
            stack.append(i)
            marks.append((s, 1, i))
            marks.append((e, 0, i))
        marks.sort()
        self.times: List[float] = []
        self.open: List[Dict[int, int]] = []  # {thread: innermost span} from times[k] on
        active: Dict[int, List[int]] = defaultdict(list)
        for t, opening, i in marks:
            tid = self.ranges[i][2]
            if opening:
                active[tid].append(i)
            elif i in active[tid]:
                active[tid].remove(i)
            now = {th: max(ids, key=lambda j: self.depth[j]) for th, ids in active.items() if ids}
            if self.times and self.times[-1] == t:
                self.open[-1] = now
            else:
                self.times.append(t)
                self.open.append(now)

    def at(self, t: float) -> Dict[int, int]:
        k = bisect.bisect_right(self.times, t) - 1
        return self.open[k] if k >= 0 else {}

    def innermost(self, t: float, tid: Optional[int]) -> int:
        """The innermost span open at t on thread tid; where tid has none,
        the innermost open on any thread (the deepest, then the shortest);
        -1 where none is open."""
        now = self.at(t)
        return now[tid] if tid in now else self._deepest(now)

    def innermost_many(self, t: np.ndarray, tids: np.ndarray) -> np.ndarray:
        """`innermost` at each of the times t on the threads tids (-1: none)."""
        if not self.times:
            return np.full(len(t), -1, np.int64)
        if self._by_thread is None:
            threads = sorted({r[2] for r in self.ranges})
            self._by_thread = {th: np.array([o.get(th, -1) for o in self.open], np.int64)
                               for th in threads}
            self._any = np.array([self._deepest(o) for o in self.open], np.int64)
        k = np.searchsorted(np.asarray(self.times), t, side="right") - 1
        kk = np.maximum(k, 0)
        out = np.where(k >= 0, self._any[kk], -1)
        for th, arr in self._by_thread.items():
            on = (tids == th) & (k >= 0)
            own = arr[kk[on]]
            out[on] = np.where(own >= 0, own, out[on])
        return out

    def _deepest(self, now: Dict[int, int]) -> int:
        """The deepest of the spans open on each thread, then the shortest."""
        if not now:
            return -1
        return max(now.values(),
                   key=lambda j: (self.depth[j], self.ranges[j][0] - self.ranges[j][1]))

    def ancestors(self, i: int) -> List[int]:
        out = []
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out

    def common(self, a: int, b: int) -> int:
        if a < 0 or b < 0:
            return -1
        up = set(self.ancestors(a))
        return next((j for j in self.ancestors(b) if j in up), -1)

    def label(self, i: int) -> str:
        return self.ranges[i][3]


def _unlinked(streams, linked, attr, la_t, la_tid, spans: _Spans) -> None:
    """Attribute each piece of work with no launch (attr -2) from its
    in-order neighbours on its stream (the module docstring)."""
    for stream in np.unique(streams[attr == -2]):
        on = streams == stream
        have = np.nonzero(on & linked)[0]
        for i in np.nonzero(on & (attr == -2))[0]:
            k = int(np.searchsorted(have, i))
            p = int(have[k - 1]) if k > 0 else None
            n = int(have[k]) if k < len(have) else None
            if p is None or n is None:
                attr[i] = -1 if p is None and n is None else attr[p if n is None else n]
            elif attr[p] == attr[n]:
                attr[i] = attr[p]
            else:
                lp, ln, tid = la_t[p], la_t[n], la_tid[p]
                inside = []
                for j in range(bisect.bisect_right(spans.starts, lp), len(spans.ranges)):
                    s, e, th, _ = spans.ranges[j]
                    if s >= ln:
                        break
                    if th == tid and e < ln:
                        inside.append(j)
                outer = [j for j in inside if spans.parent[j] not in inside]
                attr[i] = outer[0] if len(outer) == 1 else \
                    spans.common(int(attr[p]), int(attr[n]))


def _port_kernel(name: str) -> int:
    return next((k for k, pat in enumerate(PORT_KERNELS) if pat in name), -1)


def _launches_of(corrs: np.ndarray, launches: List[tuple]):
    """(linked, launch time, launch thread) of each piece of work, by its
    correlation id among the launches' (id, time, thread)."""
    lw = np.array(launches, dtype=np.float64).reshape(-1, 3)
    if not len(lw):
        return (np.zeros(len(corrs), bool), np.full(len(corrs), np.nan),
                np.full(len(corrs), -1, np.int64))
    by = np.argsort(lw[:, 0], kind="stable")
    lc = lw[by, 0].astype(np.int64)
    k = np.minimum(np.searchsorted(lc, corrs), len(lc) - 1)
    linked = (corrs != 0) & (lc[k] == corrs)
    return (linked, np.where(linked, lw[by, 1][k], np.nan),
            np.where(linked, lw[by, 2][k], -1).astype(np.int64))


def reduce(events) -> dict:
    """{"spans": {name: {"count", "busy_s", "idle_s", "kernels"}},
    "coverage", "gaps_s" (every gap between the window's first and last
    work), "shift_us", "unlinked", "port_kernels": {name: {kernel: n}},
    "idle_gaps": [[name, s], ...]} of (name, on the device, start us, end
    us, thread, correlation id, stream) events; names without "vcvits.".
    None where no program span is there."""
    prog, bench, work, names, launches = [], [], [], [], []
    for name, on_device, s, e, tid, corr, stream in events:
        if on_device:
            if not name.startswith(BENCH):  # a benchmark range's mirror is not work
                work.append((s, e, corr, stream))
                names.append(name)
        elif corr:  # a launch (the ranges carry none)
            launches.append((corr, s, tid))
        elif name.startswith(PROGRAM):
            prog.append((s, e, tid, name[len(PROGRAM):]))
        elif name.startswith(BENCH):
            bench.append((s, e, tid, name[len(BENCH):]))
    if not prog:
        return None
    spans, marks = _Spans(prog), _Spans(bench)
    n = len(spans.ranges)
    w = np.array(work, dtype=np.float64).reshape(-1, 4)
    order = np.lexsort((w[:, 1], w[:, 0]))
    starts, ends = w[order, 0], w[order, 1]
    streams = w[order, 3].astype(np.int64)
    names = [names[i] for i in order]
    linked, la_t, la_tid = _launches_of(w[order, 2].astype(np.int64), launches)
    attr = np.full(len(starts), -2, np.int64)
    attr[linked] = spans.innermost_many(la_t[linked], la_tid[linked])
    unlinked = int((~linked).sum())
    if unlinked:
        _unlinked(streams, linked, attr, la_t, la_tid, spans)
    # the least shift of the device clock that puts linked work after its
    # launch (for the gaps that unlinked work ends)
    lead = (la_t - starts)[linked]
    shift = max(0.0, float(lead.max()) if len(lead) else 0.0)
    # the busy time each piece adds to the union of the work before it
    reach = np.concatenate([[-np.inf], np.maximum.accumulate(ends)[:-1]])
    part = np.clip(ends - np.maximum(starts, reach), 0.0, None)
    # on the host's clock a gap began its length before the launch of the
    # work that ends it: the card starts work as it comes
    gi = np.nonzero(starts > reach)[0]
    gi = gi[gi > 0]
    glen = starts[gi] - reach[gi]
    gat = np.where(linked[gi], la_t[gi] - glen, reach[gi] + shift)
    gattr = spans.innermost_many(gat, la_tid[gi])
    mine, gmine = attr >= 0, gattr >= 0
    busy = np.bincount(attr[mine], weights=part[mine], minlength=n)
    items = np.bincount(attr[mine], minlength=n)
    idle = np.bincount(gattr[gmine], weights=glen[gmine], minlength=n)
    inside = float(part[mine].sum())
    below = float(part[mine & (np.array(spans.parent + [-1])[attr] >= 0)].sum())
    kind = {nm: _port_kernel(nm) for nm in set(names)}
    pk = np.array([kind[nm] for nm in names], np.int64)
    port: Dict[int, Counter] = defaultdict(Counter)
    for j, kk in zip(attr[mine & (pk >= 0)].tolist(), pk[mine & (pk >= 0)].tolist()):
        port[j][PORT_KERNELS[kk]] += 1
    out: Dict[str, dict] = {}
    kernels: Dict[str, Counter] = defaultdict(Counter)
    blank = {"count": 0, "busy_s": 0.0, "idle_s": 0.0, "kernels": 0}
    for j in range(n):
        rec = out.setdefault(spans.label(j), dict(blank))
        rec["count"] += 1
        rec["kernels"] += int(items[j])
        # a span's time counts for every span it lies in, each name once
        for a in dict.fromkeys(spans.label(x) for x in spans.ancestors(j)):
            anc = out.setdefault(a, dict(blank))
            anc["busy_s"] += float(busy[j]) / 1e6
            anc["idle_s"] += float(idle[j]) / 1e6
            kernels[a].update(port[j])
    named = []
    for g in np.lexsort((-gat, -glen))[:TOP]:
        us, j = float(glen[g]), int(gattr[g])
        if j >= 0:
            named.append([PROGRAM + spans.label(j), us / 1e6])
        else:
            b = marks.innermost(float(gat[g]), None)
            named.append([BENCH + marks.label(b) if b >= 0 else OUTSIDE, us / 1e6])
    return {"spans": out, "coverage": below / inside if inside > 0 else None,
            "gaps_s": float(glen.sum()) / 1e6, "shift_us": shift, "unlinked": unlinked,
            "port_kernels": {k: dict(v) for k, v in kernels.items() if v},
            "idle_gaps": named}


def _traced_profile():
    """The profiler of the traced window: a benchmark.tracing.Tracer's, in
    the locals of a caller of this reader (benchmark/harness.py:execute)."""
    tracing = sys.modules.get("benchmark.tracing")
    if tracing is None:
        return None
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, tracing.Tracer) and value.prof is not None:
                return value.prof
        frame = frame.f_back
    return None


def _program_spans_anything() -> bool:
    """Whether the program under test marks spans at all. A program without
    `utils/profiling.span` (an older checkout, measured with this benchmark)
    records none: its traced window is not read again for them, and its
    readers return None."""
    mod = sys.modules.get("vcvits_tpu_torch.utils.profiling")
    return mod is not None and hasattr(mod, "span")


def program(rec: dict) -> Optional[dict]:
    """The record's program spans: its "program" entry, else the reduction
    of the traced window's profiler (once a profiler). Raises where the
    program marks spans and no caller holds the traced profiler: the
    harness would drop the readers' None without a word."""
    if "program" in rec:
        return rec["program"]
    if not rec or not _program_spans_anything():
        return None
    prof = _traced_profile()
    if prof is None:
        raise RuntimeError("the program marks spans, but no caller of the reader holds a "
                           "traced benchmark.tracing.Tracer (benchmark/harness.py:execute)")
    if id(prof) not in _CACHE:
        _CACHE.clear()
        _CACHE[id(prof)] = reduce(events_of(prof))
    return _CACHE[id(prof)]


def _sum(p: Optional[dict], names, key: str) -> Optional[float]:
    got = [p["spans"][n][key] for n in names if n in p["spans"]] if p else []
    return sum(got) if got else None


def busy_ms(rec: dict, names, outer: str) -> Optional[float]:
    """The card's busy seconds on the work of the spans `names`, in ms per
    span `outer` (a step, a request) read; None where none of the spans is
    there. The profiler slows the host, not the card's work."""
    p = program(rec)
    got = _sum(p, names, "busy_s")
    if got is None or not p["spans"].get(outer, {}).get("count"):
        return None
    return got * 1e3 / p["spans"][outer]["count"]


def idle_ms(rec: dict, names, per: str) -> Optional[float]:
    """The card's idle ms an operation of the untraced window
    (benchmark/metrics/_read.py:idle_pct, over the operations rec["untraced"]
    [per] it completed) times the spans' share of the traced window's gaps;
    None where none of the spans is there. The profiler slows the host, so
    the traced gaps read long; their shares are taken from them, their
    length from the window that ran as a --trace 0 run runs."""
    p = program(rec)
    got = _sum(p, names, "idle_s")
    pct = idle_pct(rec)
    per_op = (rec.get("untraced") or {}).get(per)
    if got is None or not p.get("gaps_s") or pct is None or not per_op:
        return None
    return got / p["gaps_s"] * pct / 100.0 * rec["untraced"]["window_s"] / per_op * 1e3
