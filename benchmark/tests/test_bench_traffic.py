"""The traffic generators are deterministic in the seed, and every seed
offers the same work in another order."""

import numpy as np
import torch

from benchmark import synth
from benchmark.loops import open_loop_serve as serve
from benchmark.tests.helpers import ROOT  # noqa: F401  (sys.path)

BIG = 2 ** 31 + 977


def test_lengths_same_set_any_seed():
    a = synth.quantile_lengths(200, 3.0, 0.6, 1.0, 10.0, np.random.default_rng([BIG, 1]))
    b = synth.quantile_lengths(200, 3.0, 0.6, 1.0, 10.0, np.random.default_rng([BIG, 1]))
    c = synth.quantile_lengths(200, 3.0, 0.6, 1.0, 10.0, np.random.default_rng([BIG + 1, 1]))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and np.array_equal(np.sort(a), np.sort(c))
    assert a.min() >= 1.0 and a.max() <= 10.0
    assert abs(np.median(a) - 3.0) < 0.1


def test_arrivals_same_gaps_any_seed():
    a = serve._arrivals(300, 30.0, 10.0, BIG)
    b = serve._arrivals(300, 30.0, 10.0, BIG)
    c = serve._arrivals(300, 30.0, 10.0, BIG + 5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.allclose(np.sort(np.diff(np.append(a, 10.0))),
                       np.sort(np.diff(np.append(c, 10.0))))
    assert a[0] == 0.0 and a[-1] < 10.0 and np.all(np.diff(a) > 0)


def test_sources_deterministic_in_seed():
    secs = np.array([1.0, 1.7])
    a = synth.make_sources(secs, BIG, "cpu", 2560, 512, 512)
    b = synth.make_sources(secs, BIG, "cpu", 2560, 512, 512)
    c = synth.make_sources(secs, BIG + 1, "cpu", 2560, 512, 512)
    for x, y in zip(a, b):
        assert np.array_equal(x.wav, y.wav) and np.array_equal(x.pitch, y.pitch)
        assert x.speaker == y.speaker and x.true_len == y.true_len
    assert not np.array_equal(a[0].wav, c[0].wav)
    for s in a:
        assert len(s.wav) % 2560 == 0 and len(s.pitch) == len(s.wav) // 320
        assert np.all(s.wav[s.true_len:] == 0) and np.abs(s.wav).max() < 1.0
        assert s.pitch.min() >= 1 and s.pitch.max() < 512 and (s.pitch > 1).mean() > 0.5


def test_coarse_f0_is_the_programs():
    from vcvits_tpu_torch.dsp.pitch import coarse_f0

    f0 = np.concatenate([[0.0, 30.0], np.linspace(50.0, 1200.0, 500)])
    assert np.array_equal(synth.coarse_f0(f0), coarse_f0(f0))


def test_synth_on_device_generator_is_seeded():
    g1 = torch.Generator().manual_seed(BIG)
    g2 = torch.Generator().manual_seed(BIG)
    v = synth._vowels(torch.Generator().manual_seed(3), "cpu")
    w1, f1 = synth.synth(4000, g1, "cpu", v)
    w2, f2 = synth.synth(4000, g2, "cpu", v)
    assert torch.equal(w1, w2) and torch.equal(f1, f2)


def test_every_run_replays_the_mixs_schedule():
    """--seed draws what the requests hold; the schedule (lengths, due
    times) is the mix's own, the same in every run."""
    from benchmark.tests.helpers import tiny_context

    a = tiny_context("vc48k_base.serve", BIG, seconds=1.0)
    b = tiny_context("vc48k_base.serve", BIG + 9, seconds=1.0)
    states = []
    for ctx in (a, b):
        st = serve.setup(ctx)
        states.append(st)
        serve.free(st)
    (sa, sb) = states
    assert np.array_equal(sa.secs, sb.secs) and np.array_equal(sa.due, sb.due)
    assert not np.array_equal(sa.sources[0].wav, sb.sources[0].wav)
