"""The port's program spans (utils/profiling.py:span) and the serving
daemon's padding and queue counters.

* With no profiler recording, `span` opens no profiler range (counting
  stand-ins are patched in); under one it opens one, named
  "vcvits.<name>", whose keyword values are the ids, and which is not a
  user annotation.
* Under a CPU torch.profiler a tiny `TrainStep` call records
  "vcvits.train.step" and its nine sections, once each, in order, each
  inside the step; `timings=` is unchanged (no card: nothing recorded, as
  before). A tiny `convert_array` records its request's spans in order,
  nested in "vcvits.convert".
* The daemon's `valid_samples` + `padded_samples` are rows x padded length
  summed over its batches, the valid ones the requests' own lengths;
  queue waits are reported; `reset_stats` clears them all.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.parallel.dryrun import TINY_HUBERT, tiny_batch, tiny_config
from vcvits_tpu_torch.serving import ServingDaemon, _next_batch_size
from vcvits_tpu_torch.train.step import TrainStep
from vcvits_tpu_torch.utils import profiling

torch.set_num_threads(1)

SECTIONS = ["features", "g_forward", "g_losses", "g_backward", "g_optimizer", "d_recompute",
            "d_forward", "d_backward", "d_optimizer"]
CONVERT = ["convert", "convert.upload", "content.hubert", "hubert.features", "hubert.layers",
           "content.prior", "prior.sample", "flow.reverse", "decoder", "convert.download"]


def _spans(prof):
    """[(name without "vcvits.", start ns, end ns)] of the program's spans,
    in start order."""
    out = [(e.name()[len("vcvits."):], e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name().startswith("vcvits.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


class _Counted:
    opened = 0

    def __init__(self, name, values=(), keywords=None):
        _Counted.opened += 1
        self.name, self.keywords = name, keywords

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_opens_nothing_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _Counted)
    monkeypatch.setattr(profiling.autograd_profiler, "record_function", _Counted)
    _Counted.opened = 0
    for _ in range(3):
        with profiling.span("decoder", request=1):
            pass
    assert _Counted.opened == 0
    with profile(activities=[ProfilerActivity.CPU]):
        sp = profiling.span("decoder", request=7, batch=2)
        with sp:
            pass
    assert _Counted.opened == 1
    assert sp.name == "vcvits.decoder" and sp.keywords == {"request": 7, "batch": 2}


def test_spans_are_not_user_annotations():
    """A program span inside a caller's `record_function` leaves that one
    the innermost user annotation (the profiler draws user annotations
    again on the device over their kernels)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("bench.enc_p"):
            with profiling.span("content.hubert", request=1):
                torch.randn(8, 8) @ torch.randn(8, 8)
    kinds = {e.name(): e.is_user_annotation() for e in prof.profiler.kineto_results.events()
             if e.name() in ("bench.enc_p", "vcvits.content.hubert")}
    assert kinds == {"bench.enc_p": True, "vcvits.content.hubert": False}


@pytest.fixture(scope="module")
def step_run():
    cfg = Config.from_dict(dict(tiny_config(2), model=dict(
        tiny_config(2)["model"], multi_period_discriminator_periods=[2])))
    step = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT), seed=0)
    batch = {k: torch.as_tensor(v) for k, v in tiny_batch(2).items()}
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(batch, timings=timings)
    return _spans(prof), timings, metrics


def test_train_step_records_its_nine_sections_in_order(step_run):
    spans, timings, metrics = step_run
    names = [n for n, _, _ in spans]
    assert names.count("train.step") == 1
    sections = [s for s in spans if s[0].startswith("train.") and s[0] != "train.step"]
    assert [n for n, _, _ in sections] == ["train." + s for s in SECTIONS]
    _, t0, t1 = next(s for s in spans if s[0] == "train.step")
    for (_, a0, a1), (_, b0, _) in zip(sections, sections[1:]):
        assert t0 <= a0 < a1 <= b0 <= t1          # one after another, inside the step
    assert sections[-1][2] <= t1
    # the model's spans sit inside their sections: HuBERT in the features,
    # the prior in each generator forward
    feats = sections[0]
    assert [n for n, a, b in spans if feats[1] <= a and b <= feats[2]] == \
        ["train.features", "hubert.features", "hubert.layers"]
    inside = {name: [n for n, a, b in spans if s0 < a and b <= s1 and n == "content.prior"]
              for name, s0, s1 in sections}
    assert inside["train.g_forward"] == ["content.prior"]
    assert inside["train.d_recompute"] == ["content.prior"]
    assert float(metrics["loss/g/total"]) == float(metrics["loss/g/total"])  # finite, ran


def test_timings_keep_their_keys():
    """`timings=` on the card adds each section's device ms under the keys
    it always had; on the CPU it records nothing, as before."""
    from vcvits_tpu_torch.train import step as step_mod

    keys = ["features (smooth_source, HuBERT, K3)", "G forward",
            "G losses (MPD + MSD forward, mel, KL)", "G backward", "G grad norm + AdamW",
            "D-step generator recompute", "D forward + loss", "D backward",
            "D grad norm + AdamW"]

    class Ev:  # CUDA events stand-in: times in ms, in the order recorded
        clock = [0.0]

        def __init__(self, enable_timing=False):
            pass

        def record(self):
            Ev.clock[0] += 1.0
            self.t = Ev.clock[0]

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.t - self.t

    out = {}
    orig = torch.cuda.Event
    torch.cuda.Event = Ev
    try:
        sections = step_mod._Sections(out, torch.device("cuda"))
        with sections:
            for name, key in zip(SECTIONS, keys):
                sections.begin(name, key)
            sections.done()
    finally:
        torch.cuda.Event = orig
    assert list(out) == keys and all(v == 1.0 for v in out.values())
    cpu = {}
    with step_mod._Sections(cpu, torch.device("cpu")) as sections:
        sections.begin("features", keys[0])
        sections.done()
    assert cpu == {}


def test_convert_array_records_its_spans_in_order():
    cfg = Config.from_dict(tiny_config(1))
    vc = VoiceConverter(cfg, device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT), seed=3)
    wav = (np.random.default_rng(0).standard_normal(2 * vc.unit) * 0.1).astype(np.float32)
    pitch = np.full(len(wav) // 320, 20, np.int64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = vc.convert_array(wav, pitch, 3, len(wav) - 100)
        vc.convert_array(wav, pitch, 3)
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == CONVERT * 2
    first = spans[:len(CONVERT)]
    _, r0, r1 = first[0]
    assert all(r0 <= a and b <= r1 for _, a, b in first[1:])
    assert out.shape[0] > 0
    requests = [e for e in prof.profiler.kineto_results.events() if e.name() == "vcvits.convert"]
    assert len(requests) == 2


def test_daemon_counts_valid_and_padded_samples(vc_tiny):
    lengths = [(1, 900), (2, 300), (1, 2000)]  # (units of the source, samples cut from its end)

    class Recording(ServingDaemon):
        def __init__(self, *args, **kwargs):
            self.batches = []
            super().__init__(*args, **kwargs)

        def _gather(self):
            batch = super()._gather()
            if batch is not None:
                self.batches.append(batch)
            return batch

    with Recording(vc_tiny, max_batch=4, window_ms=300) as daemon:
        futs = []
        for units, cut in lengths:
            wav = np.zeros(units * vc_tiny.unit, np.float32)
            futs.append(daemon.submit(wav, np.zeros(len(wav) // 320, np.int64),
                                      len(wav) - cut, 1, noise_scale=0.0))
        for f in futs:
            f.result(timeout=120)
        stats = daemon.stats()
        batches = list(daemon.batches)
        total = sum(_next_batch_size(len(b), 4) * max(len(r.wav16k) for r in b) for b in batches)
        assert stats["valid_samples"] == sum(len(r.wav16k) for b in batches for r in b) - \
            sum(cut for _, cut in lengths)
        assert stats["valid_samples"] + stats["padded_samples"] == total
        assert stats["queue_wait_p95_ms"] >= stats["queue_wait_p50_ms"] >= 0
        daemon.reset_stats()
        cleared = daemon.stats()
    assert cleared == {"requests": 0, "valid_samples": 0, "padded_samples": 0}
    assert daemon._queue_waits == []


@pytest.fixture(scope="module")
def vc_tiny():
    return VoiceConverter(Config.from_dict(tiny_config(1)), device="cpu",
                          hubert_cfg=HubertConfig(**TINY_HUBERT), seed=5)


def test_daemon_spans_nest_the_model_spans(vc_tiny):
    """Under a profiler of every thread, a batch's dispatcher and resolver
    spans, with the model's spans inside "serve.infer"."""
    from torch._C._profiler import _ExperimentalConfig

    wav = np.zeros(vc_tiny.unit, np.float32)
    with ServingDaemon(vc_tiny, max_batch=2, window_ms=1) as daemon:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            daemon.submit(wav, np.zeros(len(wav) // 320, np.int64), len(wav), 1).result(
                timeout=120)
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    for name in ("serve.pad", "serve.infer", "serve.resolve_wait", "serve.resolve"):
        assert names.count(name) == 1, names
    _, i0, i1 = next(s for s in spans if s[0] == "serve.infer")
    assert [n for n, a, b in spans if i0 < a and b <= i1][:2] == ["content.hubert",
                                                                 "hubert.features"]
    assert "decoder" in [n for n, a, b in spans if i0 < a and b <= i1]
