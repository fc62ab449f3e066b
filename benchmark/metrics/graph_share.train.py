"""The share of the traced window's train steps that replayed CUDA graphs
(vcvits_tpu_torch/train/graphs.py), in %: 100 x the program spans
`vcvits.train.graph_replay` over the spans `vcvits.train.step` read
(benchmark/program_spans.py). 0 where steps ran and none replayed (on a
mesh of several ranks, or under remat, every call runs eagerly); None
where no step ran, or where the program has no CUDA graphs (no `GRAPHS`
counter in its ops/_build.py)."""

import sys

from benchmark.program_spans import program


def read(rec):
    build = sys.modules.get("vcvits_tpu_torch.ops._build")
    if build is None or not hasattr(build, "GRAPHS"):
        return None
    p = program(rec)
    steps = p["spans"].get("train.step", {}).get("count") if p else None
    if not steps:
        return None
    return 100.0 * p["spans"].get("train.graph_replay", {}).get("count", 0) / steps
