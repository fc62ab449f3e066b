"""The train cell's comparison on the CPU at the test configuration (two
rows, 1.6 s bucket): the program's bf16 step against the fp32 reference is
within the cell's limits, the fp8 control is not, nor is a step with half
its batch left out or one that leaves its state unchanged; in float32 the
program and the reference agree to rounding."""

import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.loops import train_steps
from benchmark.tests.helpers import tiny_context

SEED = 2 ** 31 + 515
SMALL = dict(batch_size=2, bucket_s=1.6, min_s=1.2, max_s=1.6, batches=3)


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def first_steps(dtype="config", fault=None):
    ctx = tiny_context("vc48k_base.train", SEED, seconds=0.5, dtype=dtype, **SMALL)
    with faults.FAULTS[fault]() if fault else _none():
        st = train_steps.setup(ctx)
        res = train_steps.window(st, ctx)
    train_steps.free(st)
    return ctx, res


class _none:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def test_float32_step_is_the_reference():
    ctx, res = first_steps("float32")
    nums, notes = train_steps.numbers(res, ctx)
    assert notes["loss_gap_first"] < 1e-5 and nums["grad_gap_median"] < 1e-4, (nums, notes)
    assert notes["loss_gap"] < 1e-4 and notes["grad_gap"] < 1e-3, notes


def test_bf16_within_limits_and_control_not():
    ctx, res = first_steps()
    correct, compared, _ = harness.check(train_steps, res, ctx)
    assert correct, compared
    ctrl, _ = train_steps.numbers(res, ctx, control=True)
    assert any(ctrl[name] > harness.limit(ctx, name) for name in ctrl), ctrl


@pytest.mark.parametrize("fault", ["half_batch_step", "unchanged_state"])
def test_faults_are_not_correct(fault):
    ctx, res = first_steps(fault=fault)
    correct, compared, _ = harness.check(train_steps, res, ctx)
    assert not correct, compared


def test_window_counts_steps():
    ctx = tiny_context("vc48k_base.train", SEED, seconds=0.5, **SMALL)
    out = harness.execute(ctx, time.perf_counter())
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_a_leaf_moved_double_fails_the_worst_leafs_limit():
    """One leaf moved twice as far as the reference's: the median leaf
    does not see it, the worst leaf's change reads about 1."""
    g = torch.Generator().manual_seed(3)
    p0 = {f"l{i}": torch.randn(64, generator=g) for i in range(9)}
    truth = {"losses": [(1.0, 1.0)],
             "grad1": {k: torch.randn(64, generator=g) for k in p0},
             "p3": {k: v + 1e-3 * torch.randn(64, generator=g) for k, v in p0.items()}}
    side = {**truth, "p3": dict(truth["p3"])}
    side["p3"]["l4"] = p0["l4"] + 2 * (truth["p3"]["l4"] - p0["l4"])
    r = train_steps.compare(side, truth, p0)
    ctx = tiny_context("vc48k_base.train", SEED)
    assert r["change_gap_median"] == 0.0
    assert r["change_gap_worst"] > harness.limit(ctx, "change_gap_worst")
