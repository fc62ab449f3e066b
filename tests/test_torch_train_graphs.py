"""The train step's CUDA graphs (train/graphs.py), their host side on the CPU.

A CUDA graph is captured and replayed only on the card (tests/
test_torch_cuda.py holds the replayed steps to the eager ones bit for bit).
Here:

* On the CPU every call runs eagerly, and counts so in `GRAPHS`.
* Under `cut_at_spans` a step's spans are boundaries and open no profiler
  range, and they come in the order the profiler records them in an eager
  step, each section's mark before its close.
* With stand-ins for the CUDA graph API (a graph that captures nothing and
  replays nothing), the bookkeeping of `StepGraphs.run`: the first call
  eager, an unseen signature captured and walked once, a seen one replayed
  (its spans opened in the eager order inside "vcvits.train.graph_replay",
  its metrics clones, its parameters' version counters moved); a capture
  that raises leaves its signature eager; `load_state_dict` forgets the
  programs; remat and a mesh of several ranks stay eager; a dropped step
  is freed at once.
* `signature`, `ops/_build.add`, the spectrogram's device tables, the
  optimizer on the CPU, `_set_lr` on a tensor rate, and a checkpoint with
  AdamW's step counts on the host resuming as the step it came from.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.dsp import spectrogram
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.parallel.dryrun import TINY_HUBERT, tiny_batch, tiny_config
from vcvits_tpu_torch.parallel.mesh import Mesh
from vcvits_tpu_torch.train import graphs
from vcvits_tpu_torch.train.checkpoint import _to_host
from vcvits_tpu_torch.train.step import StepDraws, TrainStep, _Sections
from vcvits_tpu_torch.utils import profiling

torch.set_num_threads(1)

KINDS = ("eager", "captured", "replayed", "capture_failed")


def _cfg(**train):
    raw = dict(tiny_config(2), model=dict(tiny_config(2)["model"],
                                          multi_period_discriminator_periods=[2]))
    raw["train"] = dict(raw["train"], **train)
    return Config.from_dict(raw)


def _step(**train):
    return TrainStep(_cfg(**train), device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT), seed=0)


def _batch(seed=0):
    return {k: torch.as_tensor(v) for k, v in tiny_batch(2, seed).items()}


def _counts(before):
    return {k: _build.GRAPHS[k] - before.get(k, 0) for k in KINDS}


class _Recorder:
    def __init__(self):
        self.ops = []

    def boundary(self, op):
        self.ops.append(op)


def _eager_spans(step, batch):
    """The program spans an eager call records under the CPU profiler, in
    start order, without "vcvits."."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    spans = sorted((e.start_ns(), -e.end_ns(), e.name()[len("vcvits."):])
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU and e.name().startswith("vcvits."))
    return [name for _, _, name in spans]


def test_a_cpu_step_runs_eagerly():
    step = _step()
    before = dict(_build.GRAPHS)
    for _ in range(3):
        step(_batch())
    assert _counts(before) == {"eager": 3, "captured": 0, "replayed": 0, "capture_failed": 0}
    assert step.graphs.programs == {} and not step.graphs.engages()


def test_spans_cut_a_step_in_the_order_the_profiler_records_them():
    """The boundaries of a step run under `cut_at_spans`: every span opened
    is closed, in the nesting and order an eager step's spans have under
    the profiler; each section's mark comes right before its close; and no
    profiler range opens for them."""
    step = _step()
    want = _eager_spans(step, _batch())
    rec = _Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _Sections(None, step.device) as sections:
            with profiling.cut_at_spans(rec):
                assert profiling.current_cut() is rec
                step._step(_batch(), StepDraws(), sections)
            assert profiling.current_cut() is None
    opened = [op[1] for op in rec.ops if op[0] == "open"]
    assert ["train.step"] + opened == want
    open_names = []
    for i, op in enumerate(rec.ops):
        if op[0] == "open":
            open_names.append(op[1])
        elif op[0] == "close":
            name = open_names.pop()
            if name.startswith("train."):
                assert rec.ops[i - 1][0] == "mark", name
    assert open_names == []
    marks = [op[1] for op in rec.ops if op[0] == "mark"]
    assert len(marks) == 9 and marks[0].startswith("features")
    ranges = [e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("vcvits.")]
    assert ranges == ["vcvits.train.step"]


def test_cut_at_spans_is_one_at_a_time_and_only_on_its_thread():
    import threading

    rec = _Recorder()
    seen = []
    with profiling.cut_at_spans(rec):
        with pytest.raises(RuntimeError):
            with profiling.cut_at_spans(_Recorder()):
                pass
        t = threading.Thread(target=lambda: seen.append(profiling.span("x")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [profiling._NO_SPAN] and rec.ops == []


# ---------------------------------------------------------------- stand-ins
class _FakeGraph:
    """A CUDA graph that captures nothing (on the CPU the kernels run as
    the capture goes) and replays nothing."""

    made = []
    replays = 0

    def __init__(self):
        self.generators = []
        _FakeGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def capture_begin(self, pool=None):
        self.pool = pool

    def capture_end(self):
        pass

    def replay(self):
        _FakeGraph.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA graph API replaced by stand-ins, and the step's graphs
    engaged on the CPU."""
    _FakeGraph.made, _FakeGraph.replays = [], 0
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    step = _step()
    monkeypatch.setattr(step.graphs, "engages", lambda: True)
    return step


def test_run_takes_eager_then_capture_then_replay(fake_cuda):
    step = fake_cuda
    before = dict(_build.GRAPHS)
    m1 = step(_batch(0))
    assert _counts(before)["eager"] == 1 and step.graphs.programs == {}
    m2 = step(_batch(1))     # captured, then walked once
    (prog,) = step.graphs.programs.values()
    assert _counts(before) == {"eager": 1, "captured": 1, "replayed": 0, "capture_failed": 0}
    walked = _FakeGraph.replays
    graphs_in = [op for op in prog.ops if op[0] == "graph"]
    assert walked == len(graphs_in) > 9
    assert all(g.generators == [step.generator, step.dropout_generator]
               for _, g, _ in graphs_in)
    assert all(g.pool == "pool" for _, g, _ in graphs_in)
    # the batch and draws the program reads are its own copies
    assert all(prog.batch[k] is not v and torch.equal(prog.batch[k], v)
               for k, v in _batch(1).items())
    versions = [p._version for p in step.g_params]
    m3 = step(_batch(2))     # replayed
    assert _counts(before) == {"eager": 1, "captured": 1, "replayed": 1, "capture_failed": 0}
    assert _FakeGraph.replays == 2 * walked
    assert all(p._version > v for p, v in zip(step.g_params, versions))
    assert torch.equal(prog.batch["x_wav"], _batch(2)["x_wav"])
    # the metrics are clones of the program's outputs
    assert set(m3) == set(m1) and all(m3[k] is not prog.outputs.get(k) for k in m3)
    assert all(torch.equal(m3[k], prog.outputs[k]) for k in prog.outputs)
    assert float(m2["learning_rate"]) == float(m3["learning_rate"])
    assert len(prog.grads) == len(step.g_params) + len(step.d_params)


def test_a_replay_walks_the_eager_spans_inside_graph_replay(fake_cuda):
    step = fake_cuda
    want = _eager_spans(step, _batch(0))    # eager
    step(_batch(1))                          # captured
    got = _eager_spans(step, _batch(2))      # replayed
    assert got[:2] == ["train.step", "train.graph_replay"]
    assert ["train.step"] + got[2:] == want


def test_a_capture_that_raises_leaves_its_signature_eager(fake_cuda, monkeypatch):
    step = fake_cuda
    inner = step._step

    def failing(batch, draws, sections):
        if profiling.current_cut() is not None:
            raise RuntimeError("operation not permitted when stream is capturing")
        return inner(batch, draws, sections)

    monkeypatch.setattr(step, "_step", failing)
    before = dict(_build.GRAPHS)
    step(_batch(0))
    m = step(_batch(1))
    assert _counts(before) == {"eager": 1, "captured": 0, "replayed": 0, "capture_failed": 1}
    assert list(step.graphs.programs.values()) == [None]
    assert np.isfinite(float(m["loss/g/total"]))
    step(_batch(2))
    assert _counts(before) == {"eager": 2, "captured": 0, "replayed": 0, "capture_failed": 1}


def test_signatures_part_shapes_draws_and_phases(fake_cuda):
    step = fake_cuda
    a, b = _batch(0), {k: torch.cat([v, v]) for k, v in _batch(0).items()}
    eps = torch.zeros(2, 15, 16)
    keys = {graphs.signature(a, StepDraws(), 0), graphs.signature(b, StepDraws(), 0),
            graphs.signature(a, StepDraws(eps=eps), 0), graphs.signature(a, StepDraws(), 1)}
    assert len(keys) == 4
    assert graphs.signature(a, StepDraws(), 0) == graphs.signature(_batch(1), StepDraws(), 0)
    assert graphs.signature({**a, "sid": [1, 2]}, StepDraws(), 0) is None
    before = dict(_build.GRAPHS)
    for batch in (a, b, a, b):
        step(batch)
    assert _counts(before) == {"eager": 1, "captured": 2, "replayed": 1, "capture_failed": 0}


def test_load_state_dict_forgets_the_programs(fake_cuda):
    step = fake_cuda
    step(_batch(0))
    step(_batch(1))
    assert step.graphs.programs
    step.load_state_dict(step.state_dict())
    assert step.graphs.programs == {}


def test_remat_and_meshes_stay_eager():
    assert not _step(remat_policy="dots").graphs.engages()
    step = _step()
    step.device = torch.device("cuda")
    assert step.graphs.engages()
    step.mesh = Mesh(data=2, model=1)
    assert not step.graphs.engages()


def test_a_dropped_step_is_freed_without_the_cycle_collector():
    """`StepGraphs` holds its step weakly, so a step dropped after it ran
    (with its programs, and on the card their memory pool) is freed at
    once, not at the cyclic collector's next pass."""
    import gc
    import weakref

    _step()(_batch(0))   # a process's first optimizer leaves torch's lazy imports' frames
    gc.collect()
    gc.disable()
    try:
        step = _step()
        step(_batch(0))
        assert step.graphs.step is step
        dropped = weakref.ref(step)
        del step
        assert dropped() is None
    finally:
        gc.enable()


# ------------------------------------------------------------------ the rest
def test_build_add_counts_and_takes_back(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)({"k1": 2}))
    _build.add({"k1": 3, "k2": 1})
    assert dict(_build.LAUNCHES) == {"k1": 5, "k2": 1}
    _build.add({"k1": -5, "k2": -1})
    assert dict(_build.LAUNCHES) == {}


def test_spectrogram_tables_are_copied_once_per_device():
    win = spectrogram.device_table(torch.device("cpu"), spectrogram._padded_window, 1024, 1024)
    assert win is spectrogram.device_table(torch.device("cpu"), spectrogram._padded_window,
                                           1024, 1024)
    assert torch.equal(win, torch.as_tensor(spectrogram._padded_window(1024, 1024)))
    fb = spectrogram.device_table(torch.device("cpu"), spectrogram.mel_filterbank,
                                  48000, 2048, 128, 0.0, None)
    assert torch.equal(fb, torch.as_tensor(spectrogram.mel_filterbank(48000, 2048, 128)))


def test_the_cpu_optimizer_is_as_before_and_a_tensor_rate_is_filled():
    step = _step()
    group = step.g_opt.param_groups[0]
    assert not group["capturable"] and not group["fused"] and isinstance(group["lr"], float)
    step._set_lr(0.25)
    assert group["lr"] == 0.25
    rate = torch.tensor(0.0)
    group["lr"] = rate
    step._set_lr(0.5)
    assert group["lr"] is rate and float(rate) == 0.5


def test_a_checkpoint_with_host_step_counts_resumes_as_the_step_went_on():
    """A state as a checkpoint holds it (every tensor on the host, AdamW's
    step counts too) loads into a fresh step, which then takes the same
    two steps as the step it came from: equal metrics and parameters."""
    step = _step()
    for s in range(2):
        step(_batch(s))
    state = _to_host(step.state_dict())
    assert all(m["step"].device.type == "cpu" and float(m["step"]) == 2
               for m in state["g_opt"].values())
    other = TrainStep(_cfg(), device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT), seed=5)
    other.load_state_dict(state)
    for gen in ("generator", "dropout_generator"):
        getattr(other, gen).set_state(getattr(step, gen).get_state())
    for s in range(2, 4):
        want, got = step(_batch(s)), other(_batch(s))
        assert all(torch.equal(got[k], want[k]) for k in want), s
    for p, q in zip(step.g_params + step.d_params, other.g_params + other.d_params):
        assert torch.equal(p, q)
    assert {float(m["step"]) for m in other.g_opt.state.values()} == {4.0}


def test_a_program_copies_a_calls_inputs_in():
    batch, draws = _batch(0), StepDraws(eps=torch.zeros(2, 15, 16))
    prog = graphs._Program({k: v.clone() for k, v in batch.items()},
                           dataclasses.replace(draws, eps=draws.eps.clone()))
    later = StepDraws(eps=torch.ones(2, 15, 16))
    prog.load(_batch(1), later)
    assert torch.equal(prog.batch["y_wav"], _batch(1)["y_wav"])
    assert torch.equal(prog.draws.eps, later.eps) and prog.draws.ids_str is None
