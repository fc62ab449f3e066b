"""Device ms a request of HuBERT in the content encoder
(models/content_encoder.py, models/hubert.py): the card's busy time on
work launched inside the program span `vcvits.content.hubert` (the conv
extractor and the layers), a request (`vcvits.convert`;
benchmark/program_spans.py)."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["content.hubert"], "convert")
