"""Device ms a step of the alignment in the TTS train step
(models/synthesizer_tts.py): the card's busy time on work launched inside
the program span `vcvits.tts.mas` (neg_cent, M1 and the prior expanded
to the frames), a step (`vcvits.train.step`;
benchmark/program_spans.py)."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["tts.mas"], "train.step")
