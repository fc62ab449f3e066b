"""Idle ms a step while the host is in the grad norms and AdamW steps
(train/step.py): the share of the traced window's gaps that begin while
the innermost open program span is `vcvits.train.g_optimizer` or
`vcvits.train.d_optimizer`, of the card's idle ms a step in the untraced
window (benchmark/program_spans.py:idle_ms)."""

from benchmark.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, ["train.g_optimizer", "train.d_optimizer"], "steps")
