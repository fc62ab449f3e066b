"""Idle ms a step while the host is in the step's forward sections
(train/step.py): the share of the traced window's gaps that begin while
the innermost open program span is `vcvits.train.features`, `g_forward`,
`g_losses`, `d_recompute` or `d_forward` (or a span inside one), of the
card's idle ms a step in the untraced window
(benchmark/program_spans.py:idle_ms)."""

from benchmark.program_spans import idle_ms

SECTIONS = ["train.features", "train.g_forward", "train.g_losses", "train.d_recompute",
            "train.d_forward"]


def read(rec):
    return idle_ms(rec, SECTIONS, "steps")
