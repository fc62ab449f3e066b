"""The benchmark's general part: find a cell's pieces by name, check the
cards, time set-up, trace the window, assemble and print the result.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration file
is the `file` of its `configs` entry; its traffic mix is
benchmark/traffic/<traffic>.json, whose "loop" names the module in
benchmark/loops/ that builds the system under test, runs the window and
checks the outputs against the plain reference; its per-layer metrics are
read by benchmark/metrics/<name>.py. Adding a cell, a mix or a metric adds
files and edits none of these.

A loop module has:

    setup(ctx) -> state        build the program, make the inputs, warm up
    window(state, ctx) -> res  the measured window (hooks already set; a
                               traced run calls it twice, untraced first)
    end_to_end(state, res) -> {metric: value}   without setup_s
    record(state, res) -> dict the loop's part of a traced run's record
    free(state)                drop the program's state
    numbers(res, ctx, control=False) -> ({name: number}, notes)
                               the numbers the check compares, of the
                               program's outputs (or of the control's)

and `modules(state)`: {label: nn.Module} whose forward calls become the
benchmark's host spans "bench.<label>" in a traced run.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vcvits_tpu")


class NoCard(RuntimeError):
    pass


@dataclass
class Context:
    root: str
    workload: dict
    config_entry: dict
    config: dict            # the configuration file
    traffic: dict           # the traffic mix's parameters
    seed: int
    seconds: float
    trace: bool
    device: object = None
    limits: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_context(root: str, workload: str, seed: int, seconds: float, trace: bool) -> Context:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return cell_context(root, cells[workload], seed, seconds, trace)


def cell_context(root: str, cell: dict, seed: int, seconds: float, trace: bool) -> Context:
    """The context of `cell` ({"name", "config", "traffic", "chips"}), whose
    configuration BENCHMARK.json names; the cell itself need not be there
    (the CPU tests and the knee sweep run loops that no cell runs yet)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    workload = cell["name"]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(root, "benchmark", "limits", workload + ".json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    return Context(root, cell, entry, config, traffic, seed, seconds, trace, limits=limits)


def loop_of(ctx: Context):
    return importlib.import_module(f"benchmark.loops.{ctx.traffic['loop']}")


def per_layer_entries(root: str, workload: str) -> List[dict]:
    """The per-layer metrics a traced run of `workload` reports: those that
    list it, and those without a list whose moved metric it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def has_e2e(name):
        w = e2e[name].get("workloads")
        return w is None or workload in w

    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else has_e2e(m["moves"]))]


def end_to_end_entries(root: str, workload: str) -> List[dict]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: str, name: str):
    """benchmark/metrics/<name>.py's `read`."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cards(n: int):
    """The CUDA device, or NoCard when fewer than n cards are present."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and has no CPU path")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} CUDA devices, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(ctx: Context, t_start: float) -> dict:
    """Set-up, window, metrics and check of one run on ctx.device. Returns
    the result object (without printing it)."""
    import torch

    from benchmark import tracing

    drv = loop_of(ctx)
    on_card = ctx.device.type == "cuda"
    state = drv.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    # what set-up made lives to the end: the window's collections need not
    # scan it again (a long pause there would be the benchmark's, not the
    # program's)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    tracer = plain = None
    if ctx.trace:
        # the window once untraced, as a --trace 0 run measures it: the
        # profiler slows the host-paced paths, so the shares of the card's
        # time are taken over this one (benchmark/metrics/_read.py)
        plain = drv.window(state, ctx)
        tracer = tracing.Tracer(drv.modules(state))
        tracer.start()
    res = drv.window(state, ctx)
    rec = None
    if tracer is not None:
        rec = tracer.stop()
        rec.update(drv.record(state, res))
        rec["untraced"] = {**drv.record(state, plain), "window_s": plain.window_s}
    # the fullest card's peak, read before the reference runs on it
    peak = max(int(torch.cuda.max_memory_allocated(d))
               for d in range(torch.cuda.device_count())) if on_card else 0
    metrics: Dict[str, dict] = {}
    if not ctx.trace:
        values = drv.end_to_end(state, res)
        values["setup_s"] = setup_s
        for m in end_to_end_entries(ctx.root, ctx.name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in per_layer_entries(ctx.root, ctx.name):
            v = reader(ctx.root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted, failed = res.attempted, res.failed
    drv.free(state)
    del state
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, compared, notes = check(drv, res, ctx)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                      "count": int(ctx.workload["chips"]), "memory_peak_bytes": peak}}
    if rec is not None:
        out["device"]["busy_s"] = rec["busy_s"]
        out["device"]["window_s"] = rec["window_s"]
        out["breakdown"] = rec["breakdown"]
    if rec is not None:  # each span's host records and device mirrors
        labels = set(rec["span_count"]) | set(rec["mirror_count"])
        notes["spans_host_device"] = {k: [rec["span_count"].get(k, 0),
                                          rec["mirror_count"].get(k, 0)] for k in labels}
        notes["untraced_window_s"] = rec["untraced"]["window_s"]
        if rec.get("flops") and rec["untraced"].get("flops"):
            # the profiler's cost: the traced window's work over the untraced one's
            notes["traced_work_share"] = (rec["flops"] / rec["window_s"]) / \
                (rec["untraced"]["flops"] / rec["untraced"]["window_s"])
    out["notes"] = notes
    out["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float) -> int:
    ctx = load_context(root, workload, seed, seconds, trace)
    try:
        ctx.device = require_cards(int(ctx.workload["chips"]))
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = execute(ctx, t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    out["notes"]["card"] = card_limit()
    print(f"benchmark: {json.dumps(out['notes'])}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    sys.stdout.flush()
    return 0


def check(drv, res, ctx: Context):
    """(correct, [(name, number, limit)], notes): every number the loop
    compares within its limit (benchmark/limits/<cell>.json); a number
    without a limit fails."""
    nums, notes = drv.numbers(res, ctx)
    compared = [(name, v, limit(ctx, name)) for name, v in nums.items()]
    correct = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in compared)
    return correct, compared, notes


@dataclass
class WindowResult:
    attempted: int
    failed: int
    window_s: float
    completed: int
    data: dict = field(default_factory=dict)


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| of two same-length float arrays, in float64."""
    import numpy as np

    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def limit(ctx: Context, name: str) -> Optional[float]:
    """The limit of compared number `name`: its {"limit": x, ...} entry in
    the cell's limits file (beside the readings it was set from)."""
    entry = ctx.limits.get(name)
    return entry["limit"] if entry else None
