"""The int8 decoder modes (ops/int8_conv.py, quant_int8 in models/) == JAX.

* The quantizers: codes and scales bit-equal to JAX's
  `quantize_weight_per_channel` / `quantize_act_per_row` (the leaky ReLU
  fused into the port's act quantizer, applied in float32 beforehand on
  the JAX side).
* `int8_conv1d`, W8A8 and "w8", against JAX's at rtol 1e-6 / atol 1e-6, as
  tests/test_int8_decoder.py holds JAX's to exact integer arithmetic.
* The transposed conv's scales: one per (output phase, channel), equal to
  the columns of JAX's `fold_transpose_conv_kernel` quantized per column
  for (k, s) in {(16, 8), (4, 4), (4, 2)} and fold_in in {1, 2, 4}, and to
  the rule max over the phase's taps; they differ from a plain
  per-channel scale at (16, 8). The int8 ConvTranspose1d module against
  JAX's (fold_in 1) at rtol 1e-6.
* A tiny HiFiGANGenerator (min_lanes 16 on the JAX side, so its tail
  stages really fold) in W8A8 and "w8", float32, against JAX at SNR >= 60
  dB, with JAX's dec_phase_split off and on; a tiny SynthesizerSVC.infer
  with dec_quant_int8=True at SNR >= 40 dB (noise 0). Both sides quantize
  the same way, so the error is float-order noise before a quantizer.
* VoiceConverter(quant_int8=...) decodes convert and voice_conversion in
  the chosen mode on the same weights.
float32 on the CPU; JAX on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from vcvits_tpu.models.layers import ConvTranspose1d as JaxConvTranspose1d
from vcvits_tpu.ops.folded_conv import fold_transpose_conv_kernel
from vcvits_tpu.ops.int8_conv import int8_conv1d as jax_int8_conv1d
from vcvits_tpu.ops.int8_conv import quantize_act_per_row as jax_quantize_act
from vcvits_tpu.ops.int8_conv import quantize_weight_per_channel as jax_quantize_weight
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
from vcvits_tpu_torch.models.layers import ConvTranspose1d, fold_transpose_kernel
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.int8_conv import (
    conv1d_w8a8, int8_conv1d, prepare_w8a8, quantize_act_per_row, quantize_weight_per_channel)

torch.set_num_threads(1)


def _snr_db(ref, test):
    err = np.square(ref - test).mean()
    return 10.0 * np.log10(np.square(ref).mean() / max(err, 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_quantizer_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((7, 24, 40)) * 0.05).astype(np.float32)  # JAX [k, Ci, Co]
    w[:, :, 3] = 0.0  # an all-zero column takes the 1e-12 floor
    jw = jnp.asarray(w).astype(dtype)
    jq, js = jax_quantize_weight(jw)
    tq, ts = quantize_weight_per_channel(
        torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
        .permute(2, 1, 0))
    assert torch.equal(tq.permute(2, 1, 0), torch.from_numpy(np.array(jq)))
    assert torch.equal(ts, torch.from_numpy(np.array(js)))


@pytest.mark.parametrize("dtype,slope", [("float32", None), ("float32", 0.1),
                                         ("float32", 0.01), ("bfloat16", None)])
def test_act_quantizer_bit_equal_to_jax(dtype, slope):
    """JAX quantizes leaky_relu(x) computed beforehand; the port applies the
    slope inside its quantizer, in x's dtype. (In bf16, JAX multiplies by
    the slope rounded to bf16 and torch by the float32 slope, so the fused
    activation is held in float32 only; in bf16 the quantizer of a given
    input is.)"""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 50, 16)) * 2.0).astype(np.float32)
    x[2] = 0.0  # a silent row
    jx = jnp.asarray(x).astype(dtype)
    ja = jx if slope is None else jax.nn.leaky_relu(jx, negative_slope=slope)
    jq, js = jax_quantize_act(ja)
    tq, ts = quantize_act_per_row(
        torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)), slope)
    assert torch.equal(tq, torch.from_numpy(np.array(jq)))
    assert torch.equal(ts, torch.from_numpy(np.array(js)).reshape(-1))


@pytest.mark.parametrize("act_quant", [True, False])
@pytest.mark.parametrize("dilation,pad,groups", [(1, (1, 1), 1), (3, (3, 3), 1),
                                                 (1, (2, 0), 1), (2, (2, 2), 2)])
def test_int8_conv1d_matches_jax(act_quant, dilation, pad, groups):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 12)).astype(np.float32)
    w = (rng.standard_normal((3, 12 // groups, 10)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(10) * 0.01).astype(np.float32)
    ref = jax_int8_conv1d(jnp.asarray(x), jnp.asarray(w), pad, bias=jnp.asarray(b),
                          dilation=dilation, groups=groups, act_quant=act_quant)
    got = int8_conv1d(torch.from_numpy(x), torch.from_numpy(w).permute(2, 1, 0), pad,
                      bias=torch.from_numpy(b), dilation=dilation, groups=groups,
                      act_quant=act_quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_w8a8_conv_fuses_the_activation():
    """conv1d_w8a8(x, slope) == the same conv of leaky_relu(x): bit-equal."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 33, 8)), dtype=torch.float32)
    qw = prepare_w8a8(torch.tensor(rng.standard_normal((5, 8, 3)), dtype=torch.float32))
    fused = conv1d_w8a8(x, qw, (1, 1), slope=0.1)
    assert torch.equal(fused, conv1d_w8a8(torch.nn.functional.leaky_relu(x, 0.1), qw, (1, 1)))
    assert sum(_build.LAUNCHES.values()) == 0  # the plain version, no launch on the CPU


def _phase_scale_rule(w_jax, s, p):
    """w_scale[f, o] = max(max over taps u with (f + p - u) % s == 0 and
    inputs i of |W[u, o, i]|, 1e-12) / 127, W in JAX's [k, Co, Ci]."""
    k, co, _ = w_jax.shape
    out = np.zeros((s, co), np.float32)
    for f in range(s):
        taps = [u for u in range(k) if (f + p - u) % s == 0]
        out[f] = np.maximum(np.abs(w_jax[taps]).max(axis=(0, 2)), np.float32(1e-12))
    return out / np.float32(127.0)


@pytest.mark.parametrize("fold_in", [1, 2, 4])
@pytest.mark.parametrize("k,s", [(16, 8), (4, 4), (4, 2)])
def test_transpose_scales_per_phase_and_channel_equal_jax(k, s, fold_in):
    p = (k - s) // 2
    rng = np.random.default_rng(10 * k + s)
    w = (rng.standard_normal((k, 6, 5)) * 0.05).astype(np.float32)  # JAX [k, Co, Ci]
    w[:, 2] *= np.linspace(0.1, 3.0, k)[:, None]  # the taps' maxima differ
    wf, _ = fold_transpose_conv_kernel(jnp.asarray(w), s, p, fold_in)
    jq, js = jax_quantize_weight(wf)
    got = prepare_w8a8(fold_transpose_kernel(torch.from_numpy(w).permute(2, 1, 0), s, p)[0])
    scale = got.scale.numpy().reshape(s, 6)
    assert np.array_equal(np.asarray(js).reshape(fold_in * s, 6), np.tile(scale, (fold_in, 1)))
    assert np.array_equal(scale, _phase_scale_rule(w, s, p))
    if fold_in == 1:
        assert np.array_equal(got.codes().permute(2, 1, 0).numpy(), np.asarray(jq))
    if (k, s) == (16, 8):  # a plain per-channel scale is another function
        plain = np.abs(w).max(axis=(0, 2)) / np.float32(127.0)
        assert (scale != plain[None]).sum() >= 6


@pytest.mark.parametrize("mode", [True, "w8"])
@pytest.mark.parametrize("k,s", [(16, 8), (4, 2)])
def test_int8_conv_transpose_matches_jax(mode, k, s):
    p = (k - s) // 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    jm = JaxConvTranspose1d(8, k, stride=s, padding=p, weight_norm=True, fold_in=1,
                            quant_int8=mode)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))["params"]
    params = jax.tree.map(lambda t: (rng.standard_normal(t.shape) * 0.3).astype(np.float32),
                          shapes)
    # JAX's output comes folded, [B, T, s * Co]: unfold it
    ref = np.asarray(jm.apply({"params": params}, jax.nn.leaky_relu(jnp.asarray(x), 0.1)))
    ref = ref.reshape(2, 9 * s, 8)
    tm = ConvTranspose1d(12, 8, k, stride=s, padding=p, weight_norm=True, quant_int8=mode)
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), act_slope=0.1)
    assert got.shape == (2, 9 * s, 8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


GEN_KW = dict(initial_channel=16, resblock="1", resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 5)), upsample_rates=(8, 8, 4, 2),
              upsample_initial_channel=64, upsample_kernel_sizes=(16, 16, 4, 4),
              gin_channels=8)


@pytest.fixture(scope="module")
def generator_params():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8)).astype(np.float32)
    jm = JaxGenerator(min_lanes=16, **GEN_KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, g))["params"]
    params = jax.tree.map(lambda t: (rng.standard_normal(t.shape) * 0.3).astype(np.float32),
                          shapes)
    return x, g, params


@pytest.mark.parametrize("phase_split", [False, True])
@pytest.mark.parametrize("mode", [True, "w8"])
def test_generator_int8_matches_jax(generator_params, mode, phase_split):
    x, g, params = generator_params
    jm = JaxGenerator(min_lanes=16, quant_int8=mode, phase_split=phase_split, **GEN_KW)
    ref = np.asarray(jax.jit(lambda p, x, g: jm.apply({"params": p}, x, g))(params, x, g))
    tm = HiFiGANGenerator(quant_int8=mode, **GEN_KW)
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert got.shape == ref.shape == (2, 24 * 512, 1)
    assert 0.01 < np.abs(ref).mean() < 0.9  # neither silent nor saturated
    assert _snr_db(ref, got) >= 60.0


def test_int8_weights_are_cached_and_follow_the_parameters(generator_params):
    """The quantized weights are built once and rebuilt after a parameter
    changes (load_state_dict, an in-place edit)."""
    x, g, params = generator_params
    tm = HiFiGANGenerator(quant_int8=True, **GEN_KW)
    tm.load_state_dict(params_from_jax(params))
    conv = tm.res_0_0.c1_0
    with torch.no_grad():
        first = tm(torch.from_numpy(x), torch.from_numpy(g))
        cached = conv._folded[1]
        tm(torch.from_numpy(x), torch.from_numpy(g))
        assert conv._folded[1] is cached
        conv.g.mul_(2.0)
        moved = tm(torch.from_numpy(x), torch.from_numpy(g))
    assert conv._folded[1] is not cached
    assert not torch.equal(first, moved)


HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
SYNTH_CFG = {
    "data": {"n_speakers": 8},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 1, "hubert_channels": 16, "num_pitch": 64,
              "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1, 2]],
              "upsample_initial_channel": 32, "gin_channels": 4, "p_dropout": 0.0},
}


@pytest.fixture(scope="module")
def synth():
    from vcvits_tpu.config import Config as JaxConfig
    from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
    from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth

    jm = JaxSynth.from_config(JaxConfig.from_dict(SYNTH_CFG)).clone(
        hubert_cfg=JaxHubertConfig(**HUBERT))
    w = np.zeros((1, 2560), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(  # the training forward creates every subtree
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, w,
        np.array([2560]), np.zeros((1, 8), np.int32), np.zeros((1, 40, 1025), np.float32),
        np.array([40]), sid=np.array([1]), rng=jax.random.PRNGKey(2)))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    return jm, params


def test_synthesizer_infer_int8_matches_jax(synth):
    """SynthesizerSVC.infer with dec_quant_int8=True (W8A8) against JAX's
    clone(dec_quant_int8=True), noise 0: SNR >= 40 dB; and it is not the
    float decode."""
    from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.hubert import HubertConfig

    jm, params = synth
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal((2, 7680)) * 0.2).astype(np.float32)
    lens = np.array([7680, 5000], np.int32)
    pit = rng.integers(1, 64, (2, 24))
    sid = np.array([1, 6])
    j8 = jm.clone(dec_quant_int8=True)
    ref, y_mask, _ = jax.jit(lambda p: j8.apply(
        {"params": p}, wav, lens, pit, sid=sid, noise_scale=0.0, rng=jax.random.PRNGKey(0),
        method=JaxSynth.infer))(params)
    ref = np.asarray(ref)
    outs = {}
    for mode in (False, True):
        vc = VoiceConverter.from_params(Config.from_dict(SYNTH_CFG), params, device="cpu",
                                        hubert_cfg=HubertConfig(**HUBERT), quant_int8=mode)
        assert vc.gen.dec.quant_int8 is mode
        with torch.no_grad():
            outs[mode] = vc.gen.infer(torch.from_numpy(wav), torch.from_numpy(lens),
                                      torch.from_numpy(pit), torch.from_numpy(sid),
                                      noise_scale=0.0)[0].numpy()
    assert outs[True].shape == ref.shape == (2, 45 * 512, 1)
    assert np.abs(ref).mean() > 1e-3 and np.isfinite(outs[True]).all()
    assert _snr_db(ref, outs[True]) >= 40.0
    assert _snr_db(ref, outs[False]) < _snr_db(ref, outs[True])


@pytest.mark.parametrize("mode", [True, "w8"])
def test_voice_converter_decodes_every_path_in_int8(synth, mode):
    """VoiceConverter(quant_int8=mode): convert_array and
    voice_conversion_array both decode in that mode on the same weights
    (outputs of the float lengths, within quantization noise of the float
    decode and not equal to it); the config's dec_quant_int8 works too."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.hubert import HubertConfig

    _, params = synth
    rng = np.random.default_rng(8)
    wav16 = (rng.standard_normal(7680) * 0.2).astype(np.float32)
    pit = rng.integers(1, 64, 24)
    wav48 = (rng.standard_normal(15360) * 0.2).astype(np.float32)
    cfg = Config.from_dict(SYNTH_CFG)
    vcs = {q: VoiceConverter.from_params(cfg, params, device="cpu",
                                         hubert_cfg=HubertConfig(**HUBERT), quant_int8=q)
           for q in (False, mode)}
    by_cfg = VoiceConverter.from_params(
        Config.from_dict({**SYNTH_CFG, "model": {**SYNTH_CFG["model"], "dec_quant_int8": mode}}),
        params, device="cpu", hubert_cfg=HubertConfig(**HUBERT))
    assert by_cfg.gen.dec.quant_int8 == mode
    for run in (lambda vc: vc.convert_array(wav16, pit, 3, noise_scale=0.0),
                lambda vc: vc.voice_conversion_array(wav48, 3, 5, eps=np.zeros((1, 30, 8)))):
        with torch.no_grad():
            flt, q = run(vcs[False]), run(vcs[mode])
            assert np.array_equal(run(by_cfg), q)
        assert q.shape == flt.shape and np.isfinite(q).all() and not np.array_equal(q, flt)
        assert _snr_db(flt, q) > 15.0
