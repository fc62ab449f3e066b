"""Rank 0's share of its card's peak, in %: the operations its rows of
each step need (benchmark/flops.py:train_step_flops at a card's batch)
over the untraced window's wall time, over the peak of the compute
dtype."""

from benchmark.metrics._read import mfu_pct


def read(rec):
    return mfu_pct(rec)
