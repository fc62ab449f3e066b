"""Idle ms a step while the host is in the stochastic duration
predictor's forward (models/predictors.py, hundreds of small launches):
the share of the traced window's gaps that begin while the innermost open
program span is `vcvits.tts.sdp`, of the card's idle ms a step in the
untraced window (benchmark/program_spans.py:idle_ms)."""

from benchmark.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, ["tts.sdp"], "steps")
