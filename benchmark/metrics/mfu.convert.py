"""The whole path's share of the card's peak, in %: the operations the
completed requests need alone (benchmark/flops.py), over the untraced
window's wall time, over the peak of the path's dtype."""

from benchmark.metrics._read import mfu_pct


def read(rec):
    return mfu_pct(rec)
