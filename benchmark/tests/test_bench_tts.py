"""The VITS train cell's comparison on the CPU at a narrowed VITS
configuration (two rows, 20-30 frames): the program's bf16 step against
the fp32 reference is within the cell's limits, the fp8 control is not,
nor is a step whose MAS is replaced by a uniform alignment or one on half
its batch's rows; the FLOP count's interpolation over the text length is
exact."""

import json

import pytest
import torch

from benchmark import faults_cells, flops_tts, harness
from benchmark.loops import tts_train_steps
from benchmark.tests.helpers import ROOT

SEED = 2 ** 31 + 77
SMALL = dict(batch_size=2, frames_lo=20, frames_hi=30, pad_frames=30, ids_lo=5, ids_hi=9,
             batches=3, check_steps=2)


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny(seconds=0.5) -> harness.Context:
    real = harness.load_context(ROOT, "vits_vctk.train", SEED, seconds, False)
    cfg = json.loads(json.dumps(real.config))
    cfg["config"]["model"].update(hidden_channels=32, inter_channels=16, filter_channels=64,
                                  n_layers=1, upsample_initial_channel=64, gin_channels=16,
                                  n_vocab=40)
    cfg["config"]["data"].update(n_speakers=4)
    cfg["config"]["train"].update(segment_size=2048)
    return harness.Context(ROOT, real.workload, real.config_entry, cfg,
                           dict(real.traffic, **SMALL), SEED, seconds, False,
                           device=torch.device("cpu"), limits=real.limits)


def first_steps(fault=None):
    ctx = tiny()
    with faults_cells.FAULTS[fault]() if fault else faults_cells.contextlib.nullcontext():
        st = tts_train_steps.setup(ctx)
        res = tts_train_steps.window(st, ctx)
    tts_train_steps.free(st)
    return ctx, res


def test_bf16_within_limits_and_control_not():
    ctx, res = first_steps()
    correct, compared, _ = harness.check(tts_train_steps, res, ctx)
    assert correct, compared
    ctrl, _ = tts_train_steps.numbers(res, ctx, control=True)
    assert any(ctrl[name] > harness.limit(ctx, name) for name in ctrl), ctrl


def test_uniform_alignment_is_not_correct():
    ctx, res = first_steps("uniform_alignment")
    correct, compared, _ = harness.check(tts_train_steps, res, ctx)
    assert not correct, compared


def test_half_batch_step_is_not_correct():
    ctx, res = first_steps("half_batch_tts_step")
    correct, compared, _ = harness.check(tts_train_steps, res, ctx)
    assert not correct, compared


def test_flops_interpolate_exactly_over_the_text_length():
    cfg = tiny().config["config"]
    for t_x in (11, 19):
        direct = flops_tts._count(json.dumps(cfg, sort_keys=True), (2, t_x), (2, 30 * 256))
        assert flops_tts.train_step_flops(cfg, (2, t_x), (2, 30 * 256)) == direct
