"""Device ms a step of the stochastic duration predictor's forward
(models/predictors.py): the card's busy time on work launched inside the
program span `vcvits.tts.sdp`, a step (`vcvits.train.step`;
benchmark/program_spans.py). Its backward is launched in the G backward's
section and counts there."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["tts.sdp"], "train.step")
