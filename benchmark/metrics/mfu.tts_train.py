"""The TTS train step's share of the card's peak, in %: the operations its
algorithm needs (benchmark/flops_tts.py:train_step_flops, at each step's
batch shape) over the untraced window's wall time, over the peak of its
compute dtype."""

from benchmark.metrics._read import mfu_pct


def read(rec):
    return mfu_pct(rec)
