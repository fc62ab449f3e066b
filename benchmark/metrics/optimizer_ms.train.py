"""Device ms a step of the G and D grad norms, clips and AdamW steps
(train/step.py): the card's busy time on work launched inside the program
spans `vcvits.train.g_optimizer` and `vcvits.train.d_optimizer`, a step
(`vcvits.train.step`; benchmark/program_spans.py)."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["train.g_optimizer", "train.d_optimizer"], "train.step")
