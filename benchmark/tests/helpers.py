"""What the benchmark's CPU tests share: the repo root on sys.path, and a
cell's context at the test configuration (benchmark/tests/tiny.json:
configs/48k_base.json narrowed, with a 1-layer 32-wide HuBERT) on the CPU.
Besides BENCHMARK.json's cells, the tests run the open-loop serving loop
under the cell it was built for, which BENCHMARK.json leaves out until its
tail holds a bound (PERF.md, Open questions)."""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

TINY = os.path.join(ROOT, "benchmark", "tests", "tiny.json")
NOT_IN_BENCHMARK = {"vc48k_base.serve": {"name": "vc48k_base.serve", "config": "vc48k_base",
                                         "traffic": "serve_poisson24", "chips": 1}}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_context(workload: str, seed: int, seconds: float = 2.0, trace: bool = False,
                 **traffic) -> harness.Context:
    """`workload`'s traffic and limits on the test configuration, small:
    a low rate, short sources, few requests checked."""
    if workload in NOT_IN_BENCHMARK:
        real = harness.cell_context(ROOT, NOT_IN_BENCHMARK[workload], seed, seconds, trace)
    else:
        real = harness.load_context(ROOT, workload, seed, seconds, trace)
    with open(TINY) as f:
        cfg = json.load(f)
    tr = dict(real.traffic)
    tr.update(rate=4, pool=5, median_s=1.2, max_s=2.0, check_requests=3, drain_s=30)
    tr.update(traffic)
    return harness.Context(ROOT, real.workload, real.config_entry, cfg, tr, seed, seconds, trace,
                           device=torch.device("cpu"), limits=real.limits)
