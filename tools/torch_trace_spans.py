#!/usr/bin/env python3
"""Run one benchmark cell traced and say where the program's spans put the
card's work and its idle time.

    python3 tools/torch_trace_spans.py --workload vc48k_base.train --seed 7 \
        [--seconds 51] [--out build/spans]

The cell runs as `benchmark/run.py --trace 1` runs it (its result line is
printed the same way, last on standard output but one). Then one JSON line
(also written to OUT/<workload>.<seed>.json) holds benchmark/program_spans.py's
reduction of the whole steps or requests in the middle third of the traced
window: each program span's count, busy and idle
seconds (with the spans inside it) and total gap seconds, the share of the busy
time inside a span that lies below the outermost (`coverage`), the ten
longest idle gaps named by the innermost span open at their start (a
program span, else the benchmark's), the port's kernels counted by span,
the device clock's shift, the work the profiler linked to no launch, and
the seconds the harness's own reduction and the program's took. Exits
non-zero without a card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "spans"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    from benchmark import harness, program_spans, tracing

    held, seconds = {}, {}
    stop, events_of, reduce = tracing.Tracer.stop, program_spans.events_of, program_spans.reduce

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            return out
        return call

    def keep(self):
        held["prof"] = self.prof
        return timed("harness_reduce_s", stop)(self)

    tracing.Tracer.stop = keep
    program_spans.events_of = timed("program_events_s", events_of)
    program_spans.reduce = timed("program_reduce_s", reduce)
    rc = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, True, T_START)
    if rc or "prof" not in held:
        return rc or 1
    found = program_spans._CACHE.get(id(held["prof"]))
    if found is None:
        found = program_spans.reduce(program_spans.events_of(held["prof"]))
    out = {"workload": args.workload, "seed": args.seed, "seconds": seconds,
           "run_s": time.perf_counter() - T_START, "program": found}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.{args.seed}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
