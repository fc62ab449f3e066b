"""Device ms a step of the G and D backward (train/step.py): the card's
busy time on work launched inside the program spans
`vcvits.train.g_backward` and `vcvits.train.d_backward` (autograd's
device thread launches it while the main thread is in them), a step
(`vcvits.train.step`; benchmark/program_spans.py)."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["train.g_backward", "train.d_backward"], "train.step")
