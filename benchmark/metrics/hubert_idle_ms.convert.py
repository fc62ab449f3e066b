"""Idle ms a request while the host is in HuBERT: the share of the traced
window's gaps that begin while the program span `vcvits.content.hubert`
is the innermost open (or a span inside it is), of the card's idle ms a
request in the untraced window (benchmark/program_spans.py:idle_ms).
HuBERT XTRALARGE's 48 layers' launches."""

from benchmark.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, ["content.hubert"], "completed")
