"""The comparison that decides `correct`, on the CPU at the test
configuration: the weights' names and shapes are the program's, the
program agrees with the reference, the control (the reference in TF32)
fails each cell's limit, and a run whose timed path is broken underneath
comes out not correct, once for each fault the cell can have."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import faults, harness, weights
from benchmark.loops import common
from benchmark.reference import vc as ref
from benchmark.tests.helpers import ROOT, tiny_context

SEED = 2 ** 31 + 4242


@pytest.mark.parametrize("name", ["vc48k_base", "vc_xl"])
def test_specs_are_the_programs_parameters(name):
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        c = json.load(f)["config"]
    with torch.device("meta"):
        m = SynthesizerSVC.from_config(Config.from_dict(c), device="meta", seed=None)
    have = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    spec = {n: tuple(s) for n, s, _ in
            ref.param_specs(c["model"], c["data"], ref.hubert_for(c["model"]))}
    assert have == spec


def test_weights_are_seeded():
    ctx = tiny_context("vc48k_base.serve", SEED)
    model, data, hub = common.model_blocks(ctx)
    a = weights.draw(model, data, hub, SEED, torch.device("cpu"))
    b = weights.draw(model, data, hub, SEED, torch.device("cpu"))
    c = weights.draw(model, data, hub, SEED + 1, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dec.conv_pre.v"], c["dec.conv_pre.v"])


def run(workload, **traffic):
    ctx = tiny_context(workload, SEED, seconds=1.5, **traffic)
    return harness.execute(ctx, time.perf_counter())


@pytest.mark.parametrize("workload", ["vc48k_base.serve", "vc_xl.convert"])
def test_sound_run_is_correct(workload):
    out = run(workload, check_requests=100)
    assert out["correct"], out["compared"]
    assert out["compared"]["wave_rel_err"]["value"] < 1e-5


@pytest.mark.parametrize("workload", ["vc48k_base.serve", "vc_xl.convert"])
def test_control_fails_the_limit(workload):
    """The TF32 reference in the program's place reads above the cell's
    limit, and the program below it, on the same requests."""
    ctx = tiny_context(workload, SEED, seconds=1.5, check_requests=4)
    drv = harness.loop_of(ctx)
    st = drv.setup(ctx)
    res = drv.window(st, ctx)
    drv.free(st)
    prog, _ = drv.numbers(res, ctx)
    ctrl, _ = drv.numbers(res, ctx, control=True)
    lim = harness.limit(ctx, "wave_rel_err")
    assert prog["wave_rel_err"] < lim < ctrl["wave_rel_err"]
    assert prog["answers_missing_or_misshapen"] == ctrl["answers_missing_or_misshapen"] == 0


@pytest.mark.parametrize("workload,fault", [("vc48k_base.serve", "altered_answer"),
                                            ("vc48k_base.serve", "half_batch_rows"),
                                            ("vc_xl.convert", "altered_answer")])
def test_broken_timed_path_is_not_correct(workload, fault):
    # a burst at 12/s into a 300 ms window makes batches of several rows
    with faults.FAULTS[fault]():
        out = run(workload, check_requests=100, rate=12, window_ms=300.0)
    assert not out["correct"], out["compared"]


def test_misordered_batches_are_not_correct():
    ctx = tiny_context("vc48k_base.serve", SEED, seconds=1.0, check_requests=100)
    drv = harness.loop_of(ctx)
    st = drv.setup(ctx)
    res = drv.window(st, ctx)
    drv.free(st)
    shape, lens = res.data["batches"][0]
    res.data["batches"][0] = (shape, lens + 2560)
    correct, compared, _ = harness.check(drv, res, ctx)
    assert not correct and compared[0][0] == "batches_out_of_order"


def test_every_answer_checked_is_an_answer_that_came():
    out = run("vc48k_base.serve", check_requests=2)
    assert out["notes"]["checked"] == 2
    assert all(e is not None for e in out["notes"]["wave_rel_err_each"])
    assert np.isfinite(out["compared"]["wave_rel_err"]["value"])
