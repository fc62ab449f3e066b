"""The reduction of the program's spans (benchmark/program_spans.py) on
synthetic events: work belongs to the innermost span open on its launching
thread at its launch (or on any thread, where that one has none), work
with no launch takes its stream neighbours' span, idle gaps are named by
the span open at their start, coverage; the readers of the new metrics
return nothing without spans; and the harness's own reduction reads the
same with and without the program's spans in the events."""

from benchmark import program_spans, tracing
from benchmark.tests.helpers import ROOT, bench  # noqa: F401  (sys.path)
from benchmark import harness

MAIN, AUTOGRAD = 1, 2


def span(name, start, end, tid=MAIN):
    return ("vcvits." + name, False, start, end, tid, 0, 0)


def launch(corr, at, tid=MAIN):
    return ("cudaLaunchKernel", False, at, at + 2, tid, corr, 0)


def kernel(name, start, end, corr=0, stream=7):
    return (name, True, start, end, 0, corr, stream)


def step_events():
    """A step with a forward section, a backward whose kernels autograd's
    thread launches, and a gap while the host sits in the backward."""
    return [
        span("train.step", 0, 1000), span("train.g_forward", 10, 300),
        span("train.g_backward", 300, 900),
        launch(1, 20), kernel("fwd", 100, 200, 1),
        launch(2, 400, AUTOGRAD), kernel("bwd", 410, 500, 2),
        launch(3, 850, AUTOGRAD), kernel("bwd2", 860, 880, 3),
    ]


def test_a_second_threads_launch_belongs_to_the_open_section():
    p = program_spans.reduce(step_events())
    s = p["spans"]
    assert s["train.g_forward"]["busy_s"] == 100 / 1e6
    assert s["train.g_backward"]["busy_s"] == (90 + 20) / 1e6
    assert s["train.step"]["busy_s"] == (100 + 90 + 20) / 1e6     # its sections' time
    assert s["train.g_backward"]["count"] == 1 and s["train.g_backward"]["kernels"] == 2


def test_idle_gaps_are_named_by_the_program_span_open_at_their_start():
    p = program_spans.reduce(step_events())
    # 200..410 begins while the host is still in g_forward (until 300);
    # 500..860 while it is in g_backward
    assert p["spans"]["train.g_forward"]["idle_s"] == 210 / 1e6
    assert p["spans"]["train.g_backward"]["idle_s"] == 360 / 1e6
    assert p["spans"]["train.step"]["idle_s"] == 570 / 1e6
    assert p["gaps_s"] == 570 / 1e6
    assert p["idle_gaps"] == [["vcvits.train.g_backward", 360 / 1e6],
                              ["vcvits.train.g_forward", 210 / 1e6]]


def test_a_gap_begins_its_length_before_the_launch_that_ends_it():
    """A device clock that drifts from the host's: 50 us early at first,
    170 us, then 400. The gap 100..250 ends in work launched at 420, so it
    began at host time 270, in g_forward (a single shift of 400 would put
    it at 500, in g_backward); the gap 260..600 began at 660."""
    ev = [span("train.g_forward", 0, 300), span("train.g_backward", 300, 900),
          launch(1, 50), kernel("a", 0, 100, 1), launch(2, 420), kernel("b", 250, 260, 2),
          launch(3, 1000), kernel("c", 600, 610, 3)]
    p = program_spans.reduce(ev)
    assert p["shift_us"] == 400
    assert p["spans"]["train.g_forward"]["idle_s"] == 150 / 1e6
    assert p["spans"]["train.g_backward"]["idle_s"] == 340 / 1e6


def test_a_gap_ended_by_unlinked_work_moves_by_the_shift():
    """The gap 200..240 ends in work with no launch: it began at device time
    200 moved by the shift of 150 (a's launch at 250, its start at 100),
    host time 350, in g_backward."""
    ev = [span("train.g_forward", 0, 300), span("train.g_backward", 300, 900),
          launch(1, 250), kernel("a", 100, 200, 1), kernel("b", 240, 260)]
    p = program_spans.reduce(ev)
    assert p["shift_us"] == 150 and p["unlinked"] == 1
    assert p["spans"]["train.g_backward"]["idle_s"] == 40 / 1e6
    assert p["spans"]["train.g_forward"]["idle_s"] == 0
def test_unlinked_work_takes_its_stream_neighbours_span():
    ev = [span("convert", 0, 1000), span("prior.sample", 10, 100), span("flow.reverse", 100, 300),
          span("decoder", 300, 600),
          launch(1, 20), kernel("mul", 30, 40, 1),
          # K2 with no launch between a prior kernel and a decoder kernel:
          # only flow.reverse opened after the first launch and closed
          # before the second
          kernel("wn_stack_kernel<32, 32>", 120, 220),
          kernel("wn_stack_kernel<32, 32>", 220, 250),
          launch(2, 310), kernel("conv", 320, 400, 2),
          # K1 between two decoder kernels
          kernel("mrf_pair_kernel<float, 32>", 400, 450),
          launch(3, 420), kernel("conv", 450, 470, 3)]
    p = program_spans.reduce(ev)
    assert p["unlinked"] == 3
    assert p["port_kernels"]["flow.reverse"] == {"wn_stack_kernel": 2}
    assert p["port_kernels"]["decoder"] == {"mrf_pair_kernel": 1}
    assert p["spans"]["flow.reverse"]["busy_s"] == 130 / 1e6
    assert p["spans"]["decoder"]["busy_s"] == (80 + 50 + 20) / 1e6


def test_coverage_is_the_share_below_the_outermost_span():
    ev = [span("train.step", 0, 1000), span("train.features", 0, 100),
          launch(1, 10), kernel("a", 20, 80, 1),
          launch(2, 200), kernel("b", 210, 230, 2),      # in the step, in no section
          launch(3, 2000), kernel("c", 2010, 2100, 3)]   # in no span: left out
    p = program_spans.reduce(ev)
    assert abs(p["coverage"] - 60 / 80) < 1e-12


def test_spans_on_two_threads_name_a_gap_by_the_launching_thread():
    disp, resolver = 5, 6
    ev = [span("serve.infer", 0, 500, disp), span("serve.resolve_wait", 0, 500, resolver),
          launch(1, 10, disp), kernel("a", 20, 50, 1),
          launch(2, 300, disp), kernel("b", 310, 320, 2)]
    p = program_spans.reduce(ev)
    assert p["spans"]["serve.infer"]["idle_s"] == 260 / 1e6
    assert "idle_s" not in p["spans"]["serve.resolve_wait"] or \
        p["spans"]["serve.resolve_wait"]["idle_s"] == 0


def test_no_program_span_reduces_to_none_and_the_readers_return_none(monkeypatch):
    """Readers of a record without the spans they read return None; a
    record without a "program" entry is read only where the program marks
    spans (the readers of an older program, without `span`, return None)."""
    import sys

    ev = [launch(1, 10), kernel("a", 20, 50, 1), ("bench.enc_p", False, 0, 100, MAIN, 0, 0)]
    assert program_spans.reduce(ev) is None
    rec = {"completed": 3, "steps": 3, "busy_s": 1.0, "flops": 1.0,
           "untraced": {"completed": 3, "steps": 3, "flops": 1.0, "window_s": 4.0}}
    other = {**rec, "program": program_spans.reduce([span("serve.gather", 0, 9)] + ev)}
    monkeypatch.delitem(sys.modules, "vcvits_tpu_torch.utils.profiling", raising=False)
    readers = [harness.reader(ROOT, m["name"]) for m in bench()["per_layer"]
               if "program_spans" in open(f"{ROOT}/benchmark/metrics/{m['name']}.py").read()]
    assert len(readers) == 8
    for read in readers:
        assert read({}) is None and read(rec) is None
        assert read({**rec, "program": None}) is None and read(other) is None


def test_the_readers_read_a_record_that_holds_the_program_spans():
    """Busy ms over the steps read; idle ms as the spans' share of the
    traced gaps, of the untraced window's idle ms a step: 1 - 0.21 busy s
    a flop x 2 flops / 1 s = 58 % of 1 s over 2 steps, 360 of 570 us."""
    rec = {"completed": 2, "steps": 2, "busy_s": 0.42, "flops": 2.0,
           "untraced": {"completed": 2, "steps": 2, "flops": 2.0, "window_s": 1.0},
           "program": program_spans.reduce(step_events())}
    read = harness.reader(ROOT, "backward_ms.train")
    assert abs(read(rec) - (110 / 1e6) * 1e3) < 1e-12       # one train.step
    read = harness.reader(ROOT, "backward_idle_ms.train")
    assert abs(read(rec) - 360 / 570 * 0.58 * 1e3 / 2) < 1e-9
    assert harness.reader(ROOT, "optimizer_ms.train")(rec) is None
    assert harness.reader(ROOT, "optimizer_idle_ms.train")(rec) is None


def test_the_harness_reduction_is_the_same_with_program_spans_in_the_events():
    """Every key and value of benchmark/tracing.py's record, the idle gaps'
    names included, with and without the program's spans and launches in
    the events (as its 4-field events)."""
    base = [("bench.dec", False, 0, 85), ("bench.dec", True, 10, 90),
            ("k1", True, 10, 40), ("conv", True, 60, 90), ("conv", True, 200, 210)]
    extra = [e[:4] for e in (span("decoder", 0, 95), launch(1, 5), launch(2, 55),
                             span("convert", 0, 300))]
    assert tracing.reduce(base + extra, 1.0) == tracing.reduce(base, 1.0)


def test_whole_outermost_spans_are_kept_away_from_the_ends():
    """Of three steps, the first starts before `first` and the last ends
    after `last`: only the middle one, its launches, its work and the work
    no launch links that starts in it are kept; work launched in another
    step is dropped, wherever it runs."""
    ev = [span("train.step", 0, 100), span("train.g_backward", 10, 90),
          span("train.step", 200, 300), span("train.g_backward", 210, 290),
          span("train.step", 400, 500), span("train.g_backward", 410, 490),
          launch(1, 20), kernel("a", 30, 40, 1),
          launch(2, 220), kernel("b", 230, 240, 2), kernel("k1", 240, 250),
          launch(3, 420), kernel("c", 250, 260, 3)]
    got = program_spans._whole(ev, 150, 450)
    assert [e[0] for e in got] == ["vcvits.train.step", "vcvits.train.g_backward",
                                   "cudaLaunchKernel", "b", "k1"]
    assert program_spans._whole(ev, -1e9, 1e9) == ev
    assert program_spans._whole(ev, 150, 250) == []
    p = program_spans.reduce(program_spans._whole(ev, 150, 450))
    assert p["spans"]["train.step"]["count"] == 1


def test_a_reader_finds_the_traced_profiler_among_its_callers(monkeypatch):
    """The harness hands a reader the reduced record only: the reader
    reduces the middle third of the records of the profiler of the Tracer
    in its caller's locals, whole steps only. Without one it raises, since
    the harness drops a None unseen; a program without spans is not read
    again."""
    import sys
    import time

    import pytest
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vcvits_tpu_torch.utils.profiling import span as program_span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(45):
            with program_span("train.step"):
                with program_span("train.g_backward"):
                    torch.randn(64, 64) @ torch.randn(64, 64)
                    time.sleep(0.01)
    tracer = tracing.Tracer({})
    tracer.prof = prof
    rec = {"steps": 45, "completed": 45}

    def execute():  # as benchmark/harness.py:execute calls a reader
        return harness.reader(ROOT, "backward_ms.train")(rec)

    program_spans._CACHE.clear()
    assert execute() == 0.0     # the spans are there; a CPU trace has no device work
    spans = program_spans._CACHE[id(prof)]["spans"]
    assert 1 <= spans["train.step"]["count"] <= 15
    assert spans["train.g_backward"]["count"] == spans["train.step"]["count"]
    program_spans._CACHE.clear()
    tracer.prof = None          # an untraced run's: no caller holds a traced profiler
    with pytest.raises(RuntimeError, match="no caller"):
        harness.reader(ROOT, "backward_ms.train")(rec)
    monkeypatch.delitem(sys.modules, "vcvits_tpu_torch.utils.profiling")
    assert execute() is None and not program_spans._CACHE
    del tracer


def test_events_of_a_host_trace_keep_program_and_benchmark_ranges():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vcvits_tpu_torch.utils.profiling import span as program_span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("bench.x"):
            with program_span("decoder", request=3):
                torch.randn(64, 64) @ torch.randn(64, 64)
    names = [e[0] for e in program_spans.events_of(prof, part=1)]
    assert names == ["bench.x", "vcvits.decoder"]
    p = program_spans.reduce(program_spans.events_of(prof, part=1))
    assert p["spans"]["decoder"]["count"] == 1 and p["coverage"] is None
