#!/usr/bin/env python3
"""What a program span costs the host when no profiler records.

    python3 tools/torch_span_cost.py [--n 200000]

Times, with no profiler running, N enters and exits of
`vcvits_tpu_torch.utils.profiling.span` (one flag check) beside N of the
unguarded ranges (the profiler's fast range, which a span opens while a
profiler records, and `torch.autograd.profiler.record_function`) and of an
empty loop, and prints ns per span of each, the best of five rounds, as
one JSON line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _best_ns(fn, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200000)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch._C._profiler import _RecordFunctionFast

    from vcvits_tpu_torch.utils.profiling import span

    record_function = torch.autograd.profiler.record_function

    def guarded(n):
        for i in range(n):
            with span("decoder", request=i):
                pass

    def unguarded(n):
        for i in range(n):
            with record_function("vcvits.decoder", f"request={i}"):
                pass

    def fast(n):
        for i in range(n):
            with _RecordFunctionFast("vcvits.decoder", (), {"request": i}):
                pass

    def empty(n):
        for i in range(n):
            pass

    out = {"span_ns": _best_ns(guarded, args.n),
           "fast_range_ns": _best_ns(fast, args.n),
           "record_function_ns": _best_ns(unguarded, max(args.n // 10, 1)),
           "empty_loop_ns": _best_ns(empty, args.n), "torch": torch.__version__}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
