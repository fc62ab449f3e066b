"""BENCHMARK.json against the contract's shape, and every cell resolved to
its configuration, traffic mix, loop, limits and metric readers."""

import importlib
import json
import os
import re

from benchmark.tests.helpers import ROOT, bench
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, [w["name"] for w in b["workloads"]], [c["name"] for c in b["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])


def test_every_cell_resolves():
    b = bench()
    used = set()
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        ctx = harness.load_context(ROOT, w["name"], 1, 1.0, False)
        used.add(w["config"])
        assert ctx.config["reduced"] == ctx.config_entry["reduced"]
        assert ctx.config["source"] == ctx.config_entry["source"]
        drv = importlib.import_module(f"benchmark.loops.{ctx.traffic['loop']}")
        for fn in ("setup", "window", "end_to_end", "record", "free", "numbers", "modules"):
            assert callable(getattr(drv, fn))
        assert ctx.limits and all("limit" in v for v in ctx.limits.values())
        e2e = [m["name"] for m in harness.end_to_end_entries(ROOT, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.per_layer_entries(ROOT, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e
            assert callable(harness.reader(ROOT, m["name"]))
    assert used == {c["name"] for c in b["configs"]}


def test_metrics_of_a_layer_share_its_name():
    b = bench()
    for m in b["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}


def test_readers_return_nothing_from_an_empty_record():
    for m in bench()["per_layer"]:
        assert harness.reader(ROOT, m["name"])({}) is None


def test_config_files_hold_the_repo_configs_unreduced():
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == []
        assert cfg["inference_dtype"] == "float32"


def test_config_files_are_the_shipped_configs():
    for name, shipped in (("vc48k_base", "48k_base.json"), ("vc_xl", "base.json")):
        with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
            mine = json.load(f)["config"]
        with open(os.path.join(ROOT, "configs", shipped)) as f:
            assert mine == json.load(f)
