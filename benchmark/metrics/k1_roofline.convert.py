"""K1's (ops/mrf.py -> csrc/mrf.cu) share of its roofline, in %: the least
time of every MRF stage of every decode the traced window ran
(benchmark/roofline.py:decoder_mrf_bound_ms at each decode's rows and
frames: one row, the request's own frames), over the device time of the
kernels whose name holds PATTERN."""

from benchmark import roofline
from benchmark.metrics._read import kernel_s

PATTERN = "mrf_pair_kernel"


def read(rec):
    spent = kernel_s(rec, PATTERN)
    if spent <= 0 or not rec.get("dec_inputs"):
        return None
    bound_ms = sum(roofline.decoder_mrf_bound_ms(rec["model"], b, t, rec["dtype"])
                   for b, t in rec["dec_inputs"])
    return 100.0 * bound_ms / 1e3 / spent
