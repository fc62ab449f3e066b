"""Run one cell of the benchmark of vcvits_tpu_torch and print its result.

    python3 benchmark/run.py --workload vc_xl.convert --seed 7 --seconds 51 --trace 0

From the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (benchmark/configs/<config>.json) and its traffic mix
(benchmark/traffic/<traffic>.json, which names the loop in
benchmark/loops/ that runs it); with --trace 1 its per-layer metrics are
read by benchmark/metrics/<metric>.py. The last line of standard output
is one JSON object; the numbers the correctness check compared, each
beside its limit, are the last lines of standard error. Exits non-zero,
printing no result, without enough CUDA cards, when JAX or the JAX package
is loaded, or when the program cannot be imported.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    # the package by its name from the root, not this folder's files as
    # top-level modules
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (here, ROOT)]
    from benchmark import harness

    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            T_START)


if __name__ == "__main__":
    sys.exit(main())
