"""`graph_share.train` (benchmark/metrics/graph_share.train.py) on hand-made
span counts: 100 x the replayed steps' spans over the steps' spans read,
0 where steps ran and none replayed, None without a step, and None for a
program without CUDA graphs (no `GRAPHS` counter)."""

import sys

from benchmark.tests.helpers import ROOT  # noqa: F401  (sys.path)
from benchmark import harness

import vcvits_tpu_torch.ops._build  # noqa: F401  (the program the reader asks)


def _rec(steps, replays):
    spans = {}
    if steps:
        spans["train.step"] = {"count": steps, "busy_s": 0.1, "idle_s": 0.0, "kernels": 10}
        spans["train.g_backward"] = {"count": steps, "busy_s": 0.05, "idle_s": 0.0,
                                     "kernels": 4}
    if replays:
        spans["train.graph_replay"] = {"count": replays, "busy_s": 0.1, "idle_s": 0.0,
                                       "kernels": 10}
    return {"completed": steps, "steps": steps, "program": {"spans": spans}}


def test_graph_share_reads_the_replayed_share_of_the_steps():
    read = harness.reader(ROOT, "graph_share.train")
    assert read(_rec(6, 6)) == 100.0
    assert read(_rec(6, 3)) == 50.0
    assert read(_rec(6, 0)) == 0.0
    assert read(_rec(0, 0)) is None
    assert read({"program": None}) is None and read({}) is None


def test_graph_share_of_a_program_without_graphs_is_none(monkeypatch):
    read = harness.reader(ROOT, "graph_share.train")
    monkeypatch.delattr(sys.modules["vcvits_tpu_torch.ops._build"], "GRAPHS")
    assert read(_rec(6, 6)) is None
    monkeypatch.delitem(sys.modules, "vcvits_tpu_torch.ops._build")
    assert read(_rec(6, 6)) is None
