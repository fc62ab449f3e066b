"""The card's idle share of the untraced window, in %
(benchmark/metrics/_read.py:idle_pct)."""

from benchmark.metrics._read import idle_pct


def read(rec):
    return idle_pct(rec)
