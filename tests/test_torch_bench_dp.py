"""The data-parallel train cell's rank protocol (benchmark/loops/
train_steps_dp4.py) at two ranks over gloo on the CPU, on the benchmark's
test configuration (benchmark/tests/tiny.json): rank 0 (the benchmark's
process, here a child of the test) starts its worker, runs set-up, two
windows and `free`, and every rank is gone at the end, the step matching
the plain reference on the global batch; a worker killed after set-up
ends the run with a non-zero code at once, and a step whose gradients
skip the sum fails the check."""

import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = r"""
import json, sys, torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests.helpers import tiny_context
from benchmark.loops import train_steps_dp4 as dp
mode = sys.argv[1]
ctx = tiny_context("vc48k_base.train_dp4", 2 ** 31 + 515, seconds=0.3, world=2, batch_size=1,
                   bucket_s=1.6, min_s=1.2, max_s=1.6, batches=2, check_steps=1)
if mode == "skipped_grad_sum":
    from benchmark import faults_cells
    with faults_cells.FAULTS[mode]():
        st = dp.setup(ctx)
        res = dp.window(st, ctx)
    dp.free(st)
    print(json.dumps({"correct": harness.check(dp, res, ctx)[0]}))
    sys.exit(0)
st = dp.setup(ctx)
print("set up", flush=True)
if mode == "kill":
    st.procs[0].kill()
    dp.window(st, ctx)
    dp.window(st, ctx)
    print("still running", flush=True)
    sys.exit(0)
a = dp.window(st, ctx)
b = dp.window(st, ctx)
dp.free(st)
correct, compared, _ = harness.check(dp, b, ctx)
print(json.dumps({"steps": [a.completed, b.completed], "codes": [p.returncode for p in st.procs],
                  "pids": [p.pid for p in st.procs], "correct": correct}))
"""


def run(mode: str, timeout: float):
    # two threads a process, the worker's too: the test shares the machine
    # with the suite's other workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", SCRIPT, mode], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out, time.monotonic() - t0


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_setup_two_windows_and_free():
    out, _ = run("ok", 480)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["steps"][0] >= 1 and got["steps"][1] >= 1
    assert got["codes"] == [0] and all(_gone(p) for p in got["pids"])
    assert got["correct"], out.stderr[-2000:]


def test_a_killed_worker_ends_the_run():
    out, seconds = run("kill", 480)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert "set up" in lines and "still running" not in lines


def test_skipped_gradient_sum_is_not_correct():
    out, _ = run("skipped_grad_sum", 480)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"correct": False}
