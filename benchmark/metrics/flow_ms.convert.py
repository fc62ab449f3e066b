"""Device ms a request of the flow's reverse (models/flow.py ->
ops/flow_coupling.py, K2): the card's busy time on work launched inside
the program span `vcvits.flow.reverse`, a request (`vcvits.convert`;
benchmark/program_spans.py)."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["flow.reverse"], "convert")
