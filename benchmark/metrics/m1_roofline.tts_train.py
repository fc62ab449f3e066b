"""M1's (ops/monotonic_align.py -> csrc/monotonic_align.cu) share of its
roofline in the TTS train step, in %: the least time of every MAS the
traced window ran (benchmark/roofline_tts.py:mas_bound_ms at each step's
rows, lengths and padded shape), over the device time of the kernels
whose name holds PATTERN. M1's time is set by its two serial chains a
row, not by bytes (PERF.md: the dependency-chain floor), so this share
stays far below 100 %."""

from benchmark import roofline_tts
from benchmark.metrics._read import kernel_s

PATTERN = "mas_kernel"


def read(rec):
    spent = kernel_s(rec, PATTERN)
    if spent <= 0 or not rec.get("mas_inputs"):
        return None
    bound_ms = sum(roofline_tts.mas_bound_ms(*m) for m in rec["mas_inputs"])
    return 100.0 * bound_ms / 1e3 / spent
