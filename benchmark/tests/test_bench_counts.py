"""benchmark/flops.py against torch's FlopCounterMode over the reference,
and benchmark/roofline.py against chip_smoke.py's K1 bound."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, roofline, synth, weights
from benchmark.reference import vc as ref
from benchmark.tests.helpers import tiny_context


@pytest.mark.parametrize("secs", [1.0, 1.9])
def test_infer_flops_match_the_counter(secs):
    ctx = tiny_context("vc48k_base.serve", 5)
    model, data = ctx.config["config"]["model"], ctx.config["config"]["data"]
    hub = ref.hubert_for(model, ctx.config["hubert"])
    w = weights.draw(model, data, hub, 5, torch.device("cpu"))
    s = synth.make_sources(np.array([secs]), 5, "cpu", 2560, data["n_speakers"], 512)[0]
    t_out = int(round(len(s.wav) * ref.LENGTH_SCALE))
    eps = torch.zeros(1, t_out, model["inter_channels"])
    with FlopCounterMode(display=False) as fc:
        ref.infer(w, model, hub, torch.from_numpy(s.wav)[None], torch.tensor([s.true_len]),
                  torch.from_numpy(s.pitch)[None], torch.tensor([s.speaker]), eps)
    assert fc.get_total_flops() == flops.infer_flops(model, hub, len(s.wav))


def test_full_width_counts_are_in_the_expected_range():
    """About 0.09 TFLOP a second of 48 kHz audio at configs/48k_base.json."""
    from benchmark.tests.helpers import ROOT
    import json
    import os

    with open(os.path.join(ROOT, "benchmark", "configs", "vc48k_base.json")) as f:
        model = json.load(f)["config"]["model"]
    f10 = flops.infer_flops(model, ref.HUBERT_BASE, 161280)
    assert 0.5e12 < f10 < 1.5e12


@pytest.mark.parametrize("t,c,dtype,b", [(7440, 256, "float32", 1), (59520, 128, "float32", 16),
                                         (238080, 64, "bfloat16", 1),
                                         (476160, 32, "float32", 4)])
def test_mrf_bound_is_chip_smokes(t, c, dtype, b):
    import chip_smoke

    td = torch.float32 if dtype == "float32" else torch.bfloat16
    assert roofline.mrf_bound_ms(t, c, 126, dtype, b) == chip_smoke.mrf_bound_ms(t, c, 126, td, b)
    assert roofline.bound_ms(1e12, 1e9, roofline.TF32_FLOPS) == \
        chip_smoke.bound_ms(1e12, 1e9, chip_smoke.TF32_FLOPS)


def test_decoder_bound_sums_the_stages():
    model = {"upsample_rates": [8, 8, 4, 2], "upsample_initial_channel": 512,
             "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    want = sum(roofline.mrf_bound_ms(930 * r, c, 126, "float32", 16)[0]
               for r, c in ((8, 256), (64, 128), (256, 64), (512, 32)))
    assert roofline.decoder_mrf_bound_ms(model, 16, 930, "float32") == pytest.approx(want)
