"""The module surface that no path reaches, held against the JAX package
(tests/test_aux_modules.py's modules) on shared random weights carried over
with `params_from_jax`: the classic encoder (with `output_layer` and
padding), `TransformerDecoder` (and its causality), the attention's
options (cross-attention on `c`, no window, an embedding per head, the
proximal bias), the causal and gelu `ConvFFN`, the timing signals,
`subsequent_mask`, `kl_divergence`, `normalize_pitch`, `hubert_frames` and
HubertConfig's properties, and `freq_mask` / `smooth_source(aug_rng=...)`
on an injected band. float32 on the CPU, atol 1e-5 / rtol 1e-4 (summation
order only). The encoders' call of `RelativeMultiHeadAttention` is held bit
for bit to the computation it had before these options existed.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.dsp.pitch import normalize_pitch as jax_normalize_pitch
from vcvits_tpu.models import attention as ja
from vcvits_tpu.models import hubert as jh
from vcvits_tpu.models.classic_transformer import ClassicTransformerEncoder as JaxClassic
from vcvits_tpu.train import audio_pipeline as jap
from vcvits_tpu.utils import masking as jm
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.dsp.pitch import normalize_pitch
from vcvits_tpu_torch.models import attention as ta
from vcvits_tpu_torch.models import hubert as th
from vcvits_tpu_torch.models.classic_transformer import ClassicTransformerEncoder
from vcvits_tpu_torch.models.layers import init_weights
from vcvits_tpu_torch.train import audio_pipeline as tap
from vcvits_tpu_torch.utils import masking as tm

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


def _random_params(module, *args, seed=0, scale=0.3):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
                        shapes)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _padded(b, t, valid):
    m = np.zeros((b, t, 1), np.float32)
    for i, n in enumerate(valid):
        m[i, :n] = 1.0
    return m


# ------------------------------------------------------------ masking helpers
@pytest.mark.parametrize("length,channels", [(13, 8), (7, 5), (1, 2)])
def test_timing_signals_match_jax(length, channels):
    np.testing.assert_allclose(tm.get_timing_signal_1d(length, channels).numpy(),
                               np.asarray(jm.get_timing_signal_1d(length, channels)), atol=1e-6)
    x = _normal(1, 2, length, channels)
    np.testing.assert_allclose(tm.add_timing_signal_1d(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.add_timing_signal_1d(jnp.asarray(x))), atol=1e-6)
    got = tm.cat_timing_signal_1d(torch.from_numpy(x)).numpy()
    assert got.shape == (2, length, 2 * channels)
    np.testing.assert_allclose(got, np.asarray(jm.cat_timing_signal_1d(jnp.asarray(x))),
                               atol=1e-6)


def test_subsequent_mask_and_kl_match_jax():
    np.testing.assert_array_equal(tm.subsequent_mask(6).numpy(),
                                  np.asarray(jm.subsequent_mask(6)))
    m_p, logs_p, m_q, logs_q = (_normal(i, 2, 9, 4) * 0.5 for i in range(4))
    np.testing.assert_allclose(tm.kl_divergence(*_t(m_p, logs_p, m_q, logs_q)).numpy(),
                               np.asarray(jm.kl_divergence(m_p, logs_p, m_q, logs_q)), **TOL)


# ----------------------------------------------------------------- attention
def _encoder_attention_before(attn, x, attn_mask):
    """RelativeMultiHeadAttention.forward as the encoders computed it before
    `c`, `window_size=None`, `heads_share` and `proximal_bias` were added."""
    b, t, _ = x.shape
    h, d = attn.n_heads, attn.k_channels

    def heads(y):
        return y.reshape(b, t, h, d).transpose(1, 2)

    q = heads(attn.conv_q(x)) * (1.0 / math.sqrt(d))
    k, v = heads(attn.conv_k(x)), heads(attn.conv_v(x))
    scores = torch.matmul(q, k.transpose(-1, -2))
    key_rel = ta._slice_relative_embeddings(attn.emb_rel_k.to(attn.dtype), t, attn.window_size)
    scores = scores + ta._rel_to_abs(torch.matmul(q, key_rel.transpose(-1, -2)))
    scores = scores.masked_fill(attn_mask == 0, -1e4)
    p_attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(p_attn, v)
    value_rel = ta._slice_relative_embeddings(attn.emb_rel_v.to(attn.dtype), t,
                                              attn.window_size)
    out = out + torch.matmul(ta._abs_to_rel(p_attn), value_rel)
    return attn.conv_o(out.transpose(1, 2).reshape(b, t, h * d))


def test_encoder_attention_call_unchanged_bit_for_bit():
    attn = init_weights(ta.RelativeMultiHeadAttention(16, 16, 2), 3)
    x = torch.from_numpy(_normal(2, 2, 11, 16))
    m = torch.from_numpy(_padded(2, 11, (11, 7)))[..., 0]
    mask = m[:, None, :, None] * m[:, None, None, :]
    with torch.no_grad():
        assert torch.equal(attn(x, mask), _encoder_attention_before(attn, x, mask))


@pytest.mark.parametrize("window,heads_share,proximal,cross", [
    (4, False, False, False), (None, True, True, False), (None, True, False, True),
    (2, True, True, False)])
def test_attention_options_match_jax(window, heads_share, proximal, cross):
    jmod = ja.RelativeMultiHeadAttention(16, 12, 4, window_size=window, heads_share=heads_share,
                                         proximal_bias=proximal)
    x, c = _normal(4, 2, 9, 16), _normal(5, 2, 6 if cross else 9, 16)
    kv = c if cross else x
    mask = _padded(2, 9, (9, 5))[..., 0][:, None, :, None] * \
        _padded(2, kv.shape[1], (kv.shape[1], 4))[..., 0][:, None, None, :]
    p = _random_params(jmod, x, kv, mask)
    ref = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, x, kv, mask))(p))
    tmod = ta.RelativeMultiHeadAttention(16, 12, 4, window, heads_share=heads_share,
                                         proximal_bias=proximal)
    tmod.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tmod(*_t(x, mask), c=torch.from_numpy(c) if cross else None).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("k,causal,activation", [(3, True, None), (4, True, "gelu"),
                                                  (3, False, "gelu"), (1, True, None)])
def test_conv_ffn_options_match_jax(k, causal, activation):
    jmod = ja.ConvFFN(10, 24, k, causal=causal, activation=activation)
    x, mask = _normal(6, 2, 13, 8), _padded(2, 13, (13, 9))
    p = _random_params(jmod, x, mask)
    ref = np.asarray(jax.jit(lambda p: jmod.apply({"params": p}, x, mask))(p))
    tmod = ta.ConvFFN(8, 10, 24, k, causal=causal, activation=activation)
    tmod.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        np.testing.assert_allclose(tmod(*_t(x, mask)).numpy(), ref, **TOL)


@pytest.fixture(scope="module")
def decoder():
    jdec = ja.TransformerDecoder(hidden_channels=16, filter_channels=32, n_heads=2, n_layers=2,
                                 kernel_size=3)
    x, h = _normal(7, 2, 12, 16), _normal(8, 2, 9, 16)
    x_mask, h_mask = _padded(2, 12, (12, 10)), _padded(2, 9, (9, 6))
    p = _random_params(jdec, x, x_mask, h, h_mask, scale=0.2)
    tdec = ta.TransformerDecoder(16, 32, 2, 2, kernel_size=3)
    tdec.load_state_dict(params_from_jax(p))
    apply = jax.jit(lambda x, h: jdec.apply({"params": p}, x, x_mask, h, h_mask))

    def port(x, h):
        with torch.no_grad():
            return tdec(*_t(x, x_mask, h, h_mask)).numpy()

    return apply, port, x, h


def test_decoder_matches_jax(decoder):
    apply, port, x, h = decoder
    np.testing.assert_allclose(port(x, h), np.asarray(apply(x, h)), **TOL)


def test_decoder_is_causal_and_ignores_memory_padding(decoder):
    """A change of the input from frame 8 on moves no output before frame 8
    (and moves those after); the memory's padded frames move nothing."""
    _, port, x, h = decoder
    out = port(x, h)
    x2 = x.copy()
    x2[:, 8:] = 7.0
    moved = port(x2, h)
    np.testing.assert_array_equal(moved[:, :8], out[:, :8])
    assert np.abs(moved[0, 8:] - out[0, 8:]).max() > 1e-3
    h2 = h.copy()
    h2[1, 6:] = -50.0
    np.testing.assert_allclose(port(x, h2), out, atol=1e-6)


def test_init_weights_covers_the_new_modules():
    dec = init_weights(ta.TransformerDecoder(16, 32, 2, 1, kernel_size=3), 0)
    attn = init_weights(ta.RelativeMultiHeadAttention(16, 16, 4, heads_share=False), 0)
    classic = init_weights(ClassicTransformerEncoder(16, 32, 2, 1), 0)
    assert attn.emb_rel_k.shape == (4, 9, 4) and attn.emb_rel_k.std() > 0
    assert not hasattr(dec.self_attn_0, "emb_rel_k")
    lim = math.sqrt(6.0 / 32)  # xavier-uniform, 16 x 16
    for w in (dec.self_attn_0.conv_q.weight, classic.layer_0.out.weight):
        assert 0 < w.abs().max() <= lim
    for m in (dec, attn, classic):
        assert all(torch.isfinite(p).all() for p in m.parameters())


# ------------------------------------------------------- the classic encoder
@pytest.fixture(scope="module")
def classic():
    jenc = JaxClassic(hidden_channels=16, filter_channels=32, n_heads=2, n_layers=3)
    x, mask = _normal(9, 2, 10, 16), _padded(2, 10, (10, 7))
    p = _random_params(jenc, x, mask, scale=0.2)
    tenc = ClassicTransformerEncoder(16, 32, 2, 3)
    tenc.load_state_dict(params_from_jax(p))
    return jenc, p, tenc, x, mask


@pytest.mark.parametrize("output_layer", [None, 2, 5])
def test_classic_encoder_matches_jax(classic, output_layer):
    jenc, p, tenc, x, mask = classic
    ref = np.asarray(jax.jit(lambda p: jenc.apply({"params": p}, x, mask,
                                                  output_layer=output_layer))(p))
    with torch.no_grad():
        got = tenc(*_t(x, mask), output_layer=output_layer).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_classic_encoder_respects_padding(classic):
    _, _, tenc, x, mask = classic
    x2 = x.copy()
    x2[1, 7:] = 99.0
    with torch.no_grad():
        out, out2 = (tenc(*_t(v, mask)).numpy() for v in (x, x2))
    np.testing.assert_allclose(out2[1, :7], out[1, :7], atol=1e-5)
    np.testing.assert_array_equal(out2[0], out[0])


# ---------------------------------------------------- pitch, HuBERT, SpecAug
def test_normalize_pitch_matches_jax():
    pitch = np.abs(_normal(10, 3, 40)) * 200
    pitch[:, ::5] = 0.0
    mean, std = np.array([100.0, 150.0, 210.0]), np.array([20.0, 30.0, 45.0])
    got = normalize_pitch(pitch, mean, std)
    np.testing.assert_array_equal(got, jax_normalize_pitch(pitch, mean, std))
    assert (got[:, ::5] == 0).all() and got.dtype == np.float32


@pytest.mark.parametrize("name", ["HUBERT_BASE", "HUBERT_XTRALARGE"])
def test_hubert_frames_and_properties_match_jax(name):
    tcfg, jcfg = getattr(th, name), getattr(jh, name)
    assert (tcfg.downsample, tcfg.receptive_field) == (jcfg.downsample, jcfg.receptive_field) \
        == (320, 400)
    for n in (400, 401, 719, 720, 16000, 16000 * 10 + 80):
        assert th.hubert_frames(n, tcfg) == jh.hubert_frames(n, jcfg)
    tiny = dict(conv_layers=((16, 10, 5), (16, 8, 8)))
    assert th.hubert_frames(5000, th.HubertConfig(**tiny)) == \
        jh.hubert_frames(5000, jh.HubertConfig(**tiny))


def _jax_band(key, f_bins, mask_param=80):
    """The band jap.freq_mask draws from `key`, replayed."""
    r_f, r_f0 = jax.random.split(key)
    f = int(jax.random.randint(r_f, (), 0, mask_param))
    return int(jax.random.randint(r_f0, (), 0, max(f_bins - f, 1))), f


def test_freq_mask_on_an_injected_band_matches_jax():
    re, im = _normal(11, 2, 7, 129), _normal(12, 2, 7, 129)
    key = jax.random.PRNGKey(3)
    band = _jax_band(key, 129)
    ref = jap.freq_mask(jnp.asarray(re), jnp.asarray(im), key)
    got = tap.freq_mask(*_t(re, im), band=band)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    gen = functools.partial(torch.Generator().manual_seed, 5)
    a, b = (tap.freq_mask(*_t(re, im), generator=gen())[0] for _ in range(2))
    assert torch.equal(a, b)  # the generator's draw, reproducible
    zeroed = (a == 0).all(dim=(0, 1))
    assert 0 <= int(zeroed.sum()) < 80


def test_smooth_source_with_aug_rng_matches_jax(monkeypatch):
    x = _normal(13, 2, 4096) * 0.1
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jap.smooth_source(jnp.asarray(x), 512, 128, 512, aug_rng=key))
    band = _jax_band(key, 512 // 2 + 1)
    assert band[1] > 0
    monkeypatch.setattr(tap, "freq_mask", functools.partial(tap.freq_mask, band=band))
    got = tap.smooth_source(torch.from_numpy(x), 512, 128, 512,
                            aug_rng=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    plain = tap.smooth_source(torch.from_numpy(x), 512, 128, 512).numpy()
    assert np.abs(plain - got).max() > 1e-4
