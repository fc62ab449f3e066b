"""configs/base.json (HuBERT XTRALARGE, hidden and inter 256, 256 mels,
48 kHz) through the port, mirroring tests/test_config_22k.py.

* Both shipped configs load to JAX's `Config`, field by field (to_dict),
  `max_wav_value` and the default MPD periods (base.json sets none)
  included.
* base.json routes to HUBERT_XTRALARGE (1280 wide, 48 layers, 16 heads,
  FFN 5120).
* `SynthesizerSVC.infer` at base.json's widths, HuBERT cut to 2 of its 48
  layers (1280 wide, 16 heads), port against JAX on shared N(0, 1/fan_in)
  weights, noise_scale 0, 1 s of 16 kHz audio, float32: waveform atol 1e-4.
* Two port train steps at those widths (batch 2, a 4096-sample segment:
  run-shape knobs, not widths): finite, the 1280 -> 256 `hubert_proj`.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import _draw
from vcvits_tpu.config import load_config as jax_load_config
from vcvits_tpu.models.hubert import HUBERT_XTRALARGE as JAX_XTRALARGE
from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth
from vcvits_tpu_torch.config import Config, load_config
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.hubert import HUBERT_XTRALARGE
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC, hubert_config_for

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "configs", "base.json")
XTRA_SHALLOW = dataclasses.replace(HUBERT_XTRALARGE, num_layers=2)


@pytest.mark.parametrize("name", ["48k_base.json", "base.json"])
def test_config_loads_as_jax(name):
    path = os.path.join(ROOT, "configs", name)
    port, ref = load_config(path), jax_load_config(path)
    assert port.to_dict() == ref.to_dict()
    assert port.data.max_wav_value == ref.data.max_wav_value == 32768.0
    assert tuple(port.model.multi_period_discriminator_periods) == \
        tuple(ref.model.multi_period_discriminator_periods) == \
        (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def test_base_json_routes_to_xtralarge():
    cfg = load_config(BASE)
    assert cfg.model.hubert_channels == 1280 and cfg.data.n_mel_channels == 256
    assert cfg.data.target_sampling_rate == 48000  # a 48 kHz config, not 22 kHz
    hc = hubert_config_for(cfg.model.hubert_channels)
    assert hc is HUBERT_XTRALARGE
    assert (hc.hidden_size, hc.num_layers, hc.num_heads, hc.intermediate_size) == \
        (1280, 48, 16, 5120)
    for f in ("hidden_size", "num_layers", "num_heads", "intermediate_size", "conv_layers",
              "pos_conv_kernel", "pos_conv_groups", "layer_norm_eps"):
        assert getattr(hc, f) == getattr(JAX_XTRALARGE, f), f


@pytest.fixture(scope="module")
def base_models():
    jcfg = jax_load_config(BASE)
    jm = JaxSynth.from_config(jcfg).clone(hubert_cfg=dataclasses.replace(JAX_XTRALARGE,
                                                                         num_layers=2))
    w = np.zeros((1, 2560), np.float32)
    spec = np.zeros((1, 40, jcfg.data.spec_channels), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(  # the training forward creates every subtree
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, w,
        np.array([2560]), np.zeros((1, 8), np.int32), spec, np.array([40]),
        sid=np.array([1]), rng=jax.random.PRNGKey(2)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: _draw(rng, s.shape), shapes)
    cfg = load_config(BASE)
    port = SynthesizerSVC.from_config(cfg, device="cpu", seed=None, hubert_cfg=XTRA_SHALLOW)
    port.load_state_dict(params_from_jax(params, cfg))
    port.eval()
    return jm, params, port, cfg


def test_infer_matches_jax_at_base_widths(base_models):
    jm, params, port, cfg = base_models
    assert port.enc_p.hubert_proj.weight.shape == (256, 1280)
    assert port.enc_p.hubert.layer_0.attn.q_proj.weight.shape == (1280, 1280)
    rng = np.random.default_rng(1)
    t = 16000
    wav = (rng.standard_normal((1, t)) * 0.2).astype(np.float32)
    lens = np.array([t], np.int32)
    pit = rng.integers(1, cfg.model.num_pitch, (1, t // 320))
    sid = np.array([77])
    o, y_mask, _ = jax.jit(lambda p: jm.apply(
        {"params": p}, wav, lens, pit, sid=sid, rng=jax.random.PRNGKey(3), noise_scale=0.0,
        method=JaxSynth.infer))(params)
    to, tmask, _ = port.infer(torch.from_numpy(wav), torch.from_numpy(lens),
                              torch.from_numpy(pit), torch.from_numpy(sid), noise_scale=0.0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(y_mask))
    assert to.shape == (1, 94 * 512, 1) and np.abs(np.asarray(o)).mean() > 1e-3
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-4, rtol=0)


def test_two_train_steps_at_base_widths(base_models):
    from vcvits_tpu_torch.data.loader import to_device
    from vcvits_tpu_torch.train.step import TrainStep

    _, _, port, _ = base_models
    d = load_config(BASE).to_dict()
    d["train"].update(batch_size=2, segment_size=4096)
    cfg = Config.from_dict(d)
    step = TrainStep(cfg, device="cpu", hubert_cfg=XTRA_SHALLOW, g_state=port.state_dict())
    assert step.gen.enc_p.hubert_proj.weight.shape == (256, 1280)
    g = np.random.default_rng(2)
    tx = 10240  # 0.64 s
    batch = {"x_wav": (g.standard_normal((2, tx)) * 0.1).astype(np.float32),
             "x_wav_lengths": np.array([tx, tx - 2560], np.int32),
             "x_pitch": g.integers(1, 512, (2, tx // 320)),
             "y_wav": (g.standard_normal((2, 3 * tx)) * 0.1).astype(np.float32),
             "y_wav_lengths": np.array([3 * tx, 3 * tx - 7680], np.int32),
             "sid": np.array([3, 411])}
    before = step.gen.dec.conv_pre.v.detach().clone()
    for _ in range(2):
        m = step(to_device(batch, "cpu"))
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert step.step == 2
    assert not torch.equal(step.gen.dec.conv_pre.v, before)
