"""Faults planted under the timed path, to show that the comparison that
decides `correct` catches each fault a cell can have. The CPU tests
(benchmark/tests/test_bench_correct.py) and the chip readings
(benchmark/readings.py --fault) plant them; the benchmark's own runs never
do. Each is a context manager that patches the program's class while it is
open."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def altered_answer():
    """An answer altered where it is produced: row 0 of every decode moved
    by 0.05 over 20 samples."""
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    def make(orig):
        def infer(self, *a, **k):
            o, y_mask, extra = orig(self, *a, **k)
            o = o.clone()
            o[0, 500:520] += 0.05
            return o, y_mask, extra
        return infer
    return _patched(SynthesizerSVC, "infer", make)


def half_batch_rows():
    """The second half of a served batch's rows left out (silence)."""
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    def make(orig):
        def infer(self, x_wav, *a, **k):
            o, y_mask, extra = orig(self, x_wav, *a, **k)
            if x_wav.shape[0] > 1:
                o = o.clone()
                o[x_wav.shape[0] // 2:] = 0.0
            return o, y_mask, extra
        return infer
    return _patched(SynthesizerSVC, "infer", make)


def half_batch_step():
    """A train step on the first half of its batch's rows, the mean taken
    over them."""
    from vcvits_tpu_torch.train.step import StepDraws, TrainStep

    def make(orig):
        def call(self, batch, draws=None, timings=None):
            b = batch["x_wav"].shape[0] // 2
            half = {k: v[:b] for k, v in batch.items()}
            if draws is not None:
                draws = StepDraws(*(None if t is None else t[:b] for t in
                                    (draws.eps, draws.ids_str, draws.eps2, draws.ids_str2)))
            return orig(self, half, draws, timings)
        return call
    return _patched(TrainStep, "__call__", make)


def unchanged_state():
    """A train step that leaves its state as it found it: AdamW's step does
    nothing."""
    import torch

    def make(orig):
        def step(self, closure=None):
            return None
        return step
    return _patched(torch.optim.AdamW, "step", make)


FAULTS = {"altered_answer": altered_answer, "half_batch_rows": half_batch_rows,
          "half_batch_step": half_batch_step, "unchanged_state": unchanged_state}
