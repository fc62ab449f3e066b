"""Faults of the TTS and data-parallel train cells, planted under the
timed path to show that their checks catch them (benchmark/faults.py's
kind; `import benchmark.faults_cells` adds them to its FAULTS, so that
benchmark/readings.py --fault plants them). While one is open its name
is in ACTIVE: the data-parallel loop plants it on every rank."""

from __future__ import annotations

import contextlib

from benchmark import faults

ACTIVE: set = set()


@contextlib.contextmanager
def _named(name: str, patch):
    ACTIVE.add(name)
    try:
        with patch:
            yield
    finally:
        ACTIVE.discard(name)


def skipped_grad_sum():
    """A data-parallel step whose gradients skip the sum over the data
    group: each rank steps on its own rows' share."""
    from vcvits_tpu_torch.parallel.mesh import Mesh

    def make(orig):
        def sum_grads(self, params):
            return None
        return sum_grads
    return _named("skipped_grad_sum", faults._patched(Mesh, "sum_grads", make))


def uniform_path(x_lengths, y_lengths, t_x: int, t_y: int):
    """[B, T_x, T_y]: frame y of a row on text position floor(y * x_len /
    y_len), every position the same share of the frames."""
    import torch

    dev = x_lengths.device
    ys = torch.arange(t_y, device=dev)[None, :]
    xl = x_lengths.long()[:, None]
    yl = torch.clamp_min(y_lengths.long()[:, None], 1)
    at = torch.div(ys * xl, yl, rounding_mode="floor")
    path = (torch.arange(t_x, device=dev)[None, :, None] == at[:, None, :]).float()
    return path * (ys < yl)[:, None, :].float()


def uniform_alignment():
    """The TTS step with MAS replaced by a uniform alignment."""
    from vcvits_tpu_torch.models import synthesizer_tts

    def make(orig):
        def maximum_path(neg_cent, x_lengths, y_lengths):
            b, t_y, t_x = neg_cent.shape
            return uniform_path(x_lengths, y_lengths, t_x, t_y)
        return maximum_path
    return _named("uniform_alignment",
                  faults._patched(synthesizer_tts, "maximum_path", make))


def half_batch_tts_step():
    """A TTS train step on the first half of its batch's rows, the mean
    taken over them (benchmark/faults.py's `half_batch_step` for the TTS
    step)."""
    from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep

    def make(orig):
        def call(self, batch, draws=None, timings=None):
            b = batch["y_wav"].shape[0] // 2
            half = {k: v[:b] for k, v in batch.items()}
            if draws is not None:
                draws = TTSStepDraws(*(None if t is None else t[:b] for t in
                                       (draws.eps, draws.e_q, draws.ids_str)))
            return orig(self, half, draws, timings)
        return call
    return _named("half_batch_tts_step", faults._patched(TTSTrainStep, "__call__", make))


FAULTS = {"skipped_grad_sum": skipped_grad_sum, "uniform_alignment": uniform_alignment,
          "half_batch_tts_step": half_batch_tts_step}
faults.FAULTS.update(FAULTS)
