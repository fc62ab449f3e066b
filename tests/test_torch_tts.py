"""The TTS model, port == JAX: the spline, the SDP's flows, the predictors,
the text encoder, generate_path, M1's plain version, and SynthesizerTTS's
forward, infer and voice_conversion.

tests/test_tts_train.py's tiny configuration (hidden 16, 1 layer,
resblock_dilation_sizes [[1, 3]]) on shared random weights drawn with
numpy into JAX's eval_shape tree and carried over with params_from_jax;
JAX's draws (threefry, which PyTorch cannot reproduce) are recomputed
from its key splits and injected. float32 on the CPU with TF32 off.
Tolerances: the spline atol 1e-5; the modules and the synthesizer's
tensors atol 1e-4 (rtol 1e-3), the waveform atol 1e-4; MAS paths,
generate_path, lengths and masks exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models import flow as jflow
from vcvits_tpu.models import predictors as jpred
from vcvits_tpu.models import transforms as jtransforms
from vcvits_tpu.models.synthesizer_tts import SynthesizerTTS as JaxTTS
from vcvits_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
from vcvits_tpu.ops.monotonic_align import maximum_path as jax_maximum_path
from vcvits_tpu.train.tts_step import build_tts_models
from vcvits_tpu.utils.masking import generate_path as jax_generate_path
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models import flow, predictors, transforms
from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS, neg_cent
from vcvits_tpu_torch.models.text_encoder import TextEncoder
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.monotonic_align import length_mask, maximum_path, maximum_path_plain
from vcvits_tpu_torch.utils.masking import generate_path

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_VOCAB = 40
CFG = {
    "train": {"segment_size": 2048, "batch_size": 2},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "gin_channels": 4,
              "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]]},
}
ATOL, RTOL = 1e-4, 1e-3


def _draw(rng, shape, scale=1.0):
    """N(0, scale^2 / fan_in) kernels (fan_in: every axis but the last),
    N(0, (0.2 scale)^2) vectors."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 25
    return (rng.standard_normal(shape) * scale / np.sqrt(fan_in)).astype(np.float32)


def _random_tree(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: _draw(rng, s.shape, scale), shapes)


def _close(got, want, name, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol,
                               rtol=RTOL, err_msg=name)


def _port(module, params):
    module.load_state_dict(params_from_jax(params))
    return module.eval()


# ------------------------------------------------------------- the spline
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tails", [None, "linear"])
def test_spline_matches_jax(inverse, tails):
    """float64 on both sides to 1e-6 (the arithmetic); float32 to atol 1e-5,
    or to twice JAX's own float32 distance from its float64 where that is
    larger: the inverse's root of the quadratic loses digits, and there
    JAX's float32 log-determinant is 2.3e-5 from its float64 one."""
    rng = np.random.default_rng(0)
    k, shape = 10, (3, 40)
    lo = 0.0 if tails is None else -7.0
    hi = 1.0 if tails is None else 7.0
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    uw, uh = (rng.standard_normal(shape + (k,)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal(shape + ((k - 1) if tails else (k + 1),)).astype(np.float32)
    args = (x, uw, uh, ud)

    def jax_run(dtype):
        return [np.asarray(a) for a in jtransforms.piecewise_rational_quadratic_transform(
            *(a.astype(dtype) for a in args), inverse=inverse, tails=tails, tail_bound=5.0)]

    def port_run(dtype):
        return [a.numpy() for a in transforms.piecewise_rational_quadratic_transform(
            *(torch.from_numpy(a.astype(dtype)) for a in args), inverse=inverse, tails=tails,
            tail_bound=5.0)]

    want32 = jax_run(np.float32)
    with jax.enable_x64(True):
        want64 = jax_run(np.float64)
    for name, g64, w64, g32, w32 in zip(("outputs", "logabsdet"), port_run(np.float64), want64,
                                        port_run(np.float32), want32):
        assert g32.dtype == np.float32
        np.testing.assert_allclose(g64, w64, atol=1e-6, rtol=0, err_msg=name)
        tol = max(1e-5, 2 * float(np.abs(w32 - w64).max()))
        np.testing.assert_allclose(g32, w32, atol=tol, rtol=0, err_msg=name)


def test_spline_inverse_undoes_forward():
    """In float64: in float32 the inverse's root loses digits in a flat bin
    (5e-4 at one of these 100 points)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-6, 6, (2, 50)))
    uw, uh = (torch.from_numpy(rng.standard_normal((2, 50, 10))) for _ in range(2))
    ud = torch.from_numpy(rng.standard_normal((2, 50, 9)))
    y, lad = transforms.piecewise_rational_quadratic_transform(x, uw, uh, ud, tails="linear")
    x2, lad2 = transforms.piecewise_rational_quadratic_transform(y, uw, uh, ud, inverse=True,
                                                                 tails="linear")
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=1e-9)
    np.testing.assert_allclose((lad + lad2).numpy(), 0.0, atol=1e-9)


# ------------------------------------------------------------ SDP's flows
def _mask(b, t, lengths):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


FLOW_CASES = {
    "ConvFlow": (lambda: jflow.ConvFlow(2, 16, 3, n_layers=3),
                 lambda: flow.ConvFlow(2, 16, 3, n_layers=3), 2, True),
    "DDSConv": (lambda: jflow.DDSConv(16, 3, n_layers=3),
                lambda: flow.DDSConv(16, 3, n_layers=3), 16, False),
    "ElementwiseAffine": (lambda: jflow.ElementwiseAffine(2),
                          lambda: flow.ElementwiseAffine(2), 2, False),
}


@pytest.mark.parametrize("name", sorted(FLOW_CASES))
def test_sdp_flows_match_jax(name):
    make_j, make_t, c, conditioned = FLOW_CASES[name]
    rng = np.random.default_rng(2)
    b, t = 2, 23
    x = (rng.standard_normal((b, t, c)) * 2).astype(np.float32)
    mask = _mask(b, t, [23, 15])
    g = rng.standard_normal((b, t, 16)).astype(np.float32) if conditioned else None
    jm = make_j()
    kw = {"g": g} if conditioned else {}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, mask, **kw))["params"]
    params = _random_tree(shapes, 3)
    if name == "ElementwiseAffine":
        params = jax.tree.map(lambda a: a * 3, params)
    port = _port(make_t(), params)
    tx, tm, tg = torch.from_numpy(x), torch.from_numpy(mask), None if g is None \
        else torch.from_numpy(g)
    if name == "DDSConv":
        _close(port(tx, tm, g=None), jm.apply({"params": params}, x, mask), "DDSConv")
        return
    want_y, want_ld = jm.apply({"params": params}, x, mask, **kw)
    got_y, got_ld = port(tx, tm, g=tg) if conditioned else port(tx, tm)
    _close(got_y, want_y, f"{name} forward")
    _close(got_ld, want_ld, f"{name} logdet")
    want_x = jm.apply({"params": params}, np.asarray(want_y), mask, reverse=True, **kw)
    got_x = port(got_y, tm, g=tg, reverse=True) if conditioned else port(got_y, tm, reverse=True)
    _close(got_x, want_x, f"{name} reverse")
    _close(got_x, x * mask, f"{name} round trip", atol=1e-3)


def test_log_flow_matches_jax():
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal((2, 9, 1))).astype(np.float32) + 0.1
    x[0, 0, 0] = 0.0  # below the 1e-5 clip
    mask = _mask(2, 9, [9, 5])
    jm = jflow.Log()
    want_y, want_ld = jm.apply({}, x, mask)
    got_y, got_ld = flow.Log()(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got_y, want_y, "Log forward")
    _close(got_ld, want_ld, "Log logdet")
    _close(flow.Log()(got_y, torch.from_numpy(mask), reverse=True),
           jm.apply({}, np.asarray(want_y), mask, reverse=True), "Log reverse")


# ------------------------------------------------------------- predictors
def test_variance_predictor_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 31, 8)).astype(np.float32)
    mask = _mask(2, 31, [31, 20])
    jm = jpred.VariancePredictor(32, 3, 0.1)
    params = _random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, mask))
                          ["params"], 6)
    params = jax.tree.map(lambda a: a + 0.1, params)  # LayerNorm scale / bias off 1 / 0
    port = _port(predictors.VariancePredictor(8, 32, 3, 0.1), params)
    _close(port(torch.from_numpy(x), torch.from_numpy(mask)),
           jm.apply({"params": params}, x, mask), "VariancePredictor")


def test_duration_predictor_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    g = rng.standard_normal((2, 4)).astype(np.float32)
    mask = _mask(2, 11, [11, 6])
    jm = jpred.DurationPredictor(24, 3, 0.5, gin_channels=4)
    params = _random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, mask, g=g))
                          ["params"], 8)
    port = _port(predictors.DurationPredictor(16, 24, 3, 0.5, gin_channels=4), params)
    _close(port(torch.from_numpy(x), torch.from_numpy(mask), g=torch.from_numpy(g)),
           jm.apply({"params": params}, x, mask, g=g), "DurationPredictor")


def test_average_by_duration_matches_jax():
    rng = np.random.default_rng(9)
    values = rng.standard_normal((2, 30)).astype(np.float32)
    values[values < -0.5] = 0.0
    durs = rng.integers(0, 6, (2, 8))
    _close(predictors.average_by_duration(torch.from_numpy(values), torch.from_numpy(durs)),
           jpred.average_by_duration(values, durs), "average_by_duration", atol=1e-6)


@pytest.fixture(scope="module")
def sdp():
    rng = np.random.default_rng(10)
    b, t = 2, 13
    x = rng.standard_normal((b, t, 16)).astype(np.float32)
    g = rng.standard_normal((b, 4)).astype(np.float32)
    mask = _mask(b, t, [13, 8])
    w = rng.integers(1, 6, (b, t, 1)).astype(np.float32) * mask
    jm = jpred.StochasticDurationPredictor(16, 192, 3, 0.5, 4, gin_channels=4)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, mask, w=w, g=g,
                                            rng=jax.random.PRNGKey(1)))["params"]
    params = _random_tree(shapes, 11, scale=0.5)
    port = _port(predictors.StochasticDurationPredictor(16, 192, 3, 0.5, 4, gin_channels=4),
                 params)
    return jm, params, port, x, g, mask, w


def test_sdp_nll_matches_jax(sdp):
    jm, params, port, x, g, mask, w = sdp
    key = jax.random.PRNGKey(12)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, mask, w=w, g=g, rng=key))(params)
    e_q = np.array(jax.random.normal(key, (2, 13, 2)))
    got = port(torch.from_numpy(x), torch.from_numpy(mask), w=torch.from_numpy(w),
               g=torch.from_numpy(g), noise=torch.from_numpy(e_q))
    _close(got, want, "SDP nll", atol=1e-3)


def test_sdp_sampler_matches_jax(sdp):
    """The reverse skips flow_0 (the reference's useless vflow)."""
    jm, params, port, x, g, mask, _ = sdp
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, mask, g=g, reverse=True,
                                      noise_scale=0.8, rng=key))(params)
    noise = np.array(jax.random.normal(key, (2, 13, 2)))
    got = port(torch.from_numpy(x), torch.from_numpy(mask), g=torch.from_numpy(g), reverse=True,
               noise_scale=0.8, noise=torch.from_numpy(noise))
    _close(got, want, "SDP logw")


# ----------------------------------------------------------- text encoder
def test_text_encoder_matches_jax():
    rng = np.random.default_rng(14)
    x = rng.integers(0, N_VOCAB + 5, (2, 17))  # ids past the vocabulary are clipped
    lens = np.array([17, 9])
    jm = JaxTextEncoder(N_VOCAB, 8, 16, 32, 2, 2, 3, 0.1)
    params = _random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lens))
                          ["params"], 15)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, lens))(params)
    port = _port(TextEncoder(N_VOCAB, 8, 16, 32, 2, 2, 3, 0.1), params)
    got = port(torch.from_numpy(x), torch.from_numpy(lens))
    for name, a, r in zip(("h", "m", "logs", "x_mask"), got, want):
        _close(a, r, name)


# ------------------------------------------------------ alignment helpers
def test_generate_path_matches_jax():
    rng = np.random.default_rng(16)
    dur = rng.integers(0, 5, (3, 9))
    y_mask = _mask(3, 30, [30, 12, 0])
    x_mask = _mask(3, 9, [9, 4, 2])
    want = np.asarray(jax_generate_path(dur, y_mask, x_mask))
    got = generate_path(torch.from_numpy(dur), torch.from_numpy(y_mask),
                        torch.from_numpy(x_mask)).numpy()
    np.testing.assert_array_equal(got, want)


MAS_CASES = {
    "ragged": (lambda r, s: r.standard_normal(s), [19, 11, 1, 25], [60, 34, 5, 13]),
    "ties": (lambda r, s: np.round(r.standard_normal(s)), [19, 19, 7, 3], [60, 41, 60, 3]),
    "all equal": (lambda r, s: np.zeros(s), [19, 6, 19, 2], [60, 60, 1, 9]),
    "empty rows": (lambda r, s: r.standard_normal(s) * 50, [0, 19, 4, 19], [30, 0, 60, 60]),
}


@pytest.mark.parametrize("case", sorted(MAS_CASES))
def test_maximum_path_plain_is_jax_exactly(case):
    """M1's plain version == JAX's maximum_path, every entry, on the
    lengths' mask (the synthesizer's) and through the wrapper's CPU path."""
    make, xl, yl = MAS_CASES[case]
    b, t_x, t_y = 4, 19, 60
    value = make(np.random.default_rng(17), (b, t_y, t_x)).astype(np.float32)
    mask = np.asarray(length_mask(torch.tensor(xl), torch.tensor(yl), t_x, t_y))
    want = np.asarray(jax_maximum_path(jnp.swapaxes(value, 1, 2), mask))
    got = maximum_path_plain(torch.from_numpy(value).transpose(1, 2), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    n0 = _build.LAUNCHES["monotonic_align"]
    wrapped = maximum_path(torch.from_numpy(value), torch.tensor(xl), torch.tensor(yl))
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert _build.LAUNCHES["monotonic_align"] == n0  # the CPU runs no kernel
    # a path: one x per valid frame, x non-decreasing by 0 or 1
    for i in range(b):
        if min(xl[i], yl[i]) == 0:
            assert want[i].sum() == 0
            continue
        if min(xl[i], t_x) > yl[i]:  # more text than frames: no path from (0, 0)
            continue
        xs = want[i, :, :yl[i]].argmax(0)
        assert (want[i, :, :yl[i]].sum(0) == 1).all() and xs[0] == 0
        assert set(np.diff(xs)) <= {0, 1}


def test_maximum_path_plain_takes_any_mask():
    """JAX's function on a mask that is no outer product (its lengths come
    from the first column and row)."""
    rng = np.random.default_rng(18)
    value = rng.standard_normal((2, 7, 21)).astype(np.float32)
    mask = (rng.uniform(size=(2, 7, 21)) > 0.2).astype(np.float32)
    want = np.asarray(jax_maximum_path(value, mask))
    got = maximum_path_plain(torch.from_numpy(value), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_maximum_path_refuses_bad_input():
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(2, 5, 3), torch.ones(3), torch.ones(2))
    with pytest.raises(TypeError):
        maximum_path(torch.zeros(2, 5, 3, dtype=torch.float64), torch.ones(2), torch.ones(2))


# ---------------------------------------------------------- the synthesizer
@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.from_dict(CFG)
    jm, _, _ = build_tts_models(jcfg, n_vocab=N_VOCAB)
    b, t_x, t_y = 2, 10, 30
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        np.zeros((b, t_x), np.int32), np.array([t_x, 7]),
        np.zeros((b, t_y, jcfg.data.spec_channels), np.float32), np.array([t_y, 20]),
        np.array([0, 3])))["params"]
    params = _random_tree(shapes, 19)
    port = SynthesizerTTS.from_config(Config.from_dict(CFG), device="cpu", n_vocab=N_VOCAB,
                                      seed=None)
    port.load_state_dict(params_from_jax(params, Config.from_dict(CFG)))
    return jcfg, jm, params, port.eval()


def test_forward_matches_jax(models):
    """The training forward (deterministic), JAX's posterior, SDP and
    segment draws injected: MAS's path exactly, every other output to
    atol 1e-4."""
    jcfg, jm, params, port = models
    rng = np.random.default_rng(20)
    b, t_x, t_y = 2, 10, 30
    x = rng.integers(1, N_VOCAB, (b, t_x))
    x_len, y_len = np.array([10, 7]), np.array([30, 19])
    spec = np.abs(rng.standard_normal((b, t_y, jcfg.data.spec_channels))).astype(np.float32)
    sid = np.array([1, 3])
    key = jax.random.PRNGKey(21)
    out = jax.jit(lambda p: jm.apply({"params": p}, x, x_len, spec, y_len, sid, rng=key))(params)
    (o, l_length, pitch, energy, attn, ids, x_mask, y_mask, (z, z_p, m_p, logs_p, m_q,
                                                             logs_q)) = out
    r_post, r_dur, _ = jax.random.split(key, 3)
    eps = np.array(jax.random.normal(r_post, (b, t_y, 8)))
    e_q = np.array(jax.random.normal(r_dur, (b, t_x, 2)))
    got = port(torch.from_numpy(x), torch.from_numpy(x_len), torch.from_numpy(spec),
               torch.from_numpy(y_len), torch.from_numpy(sid), eps=torch.from_numpy(eps),
               e_q=torch.from_numpy(e_q), ids_str=torch.from_numpy(np.array(ids)))
    (to, tl, tpitch, tenergy, tattn, tids, txm, tym, (tz, tz_p, tm_p, tlogs_p, tm_q,
                                                      tlogs_q)) = got
    np.testing.assert_array_equal(tattn.numpy(), np.asarray(attn))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tym.numpy(), np.asarray(y_mask))
    np.testing.assert_array_equal(txm.numpy(), np.asarray(x_mask))
    assert np.asarray(attn).sum() == 30 + 19
    with torch.no_grad():
        for name, a, r in (("z", tz, z), ("z_p", tz_p, z_p), ("m_p", tm_p, m_p),
                           ("logs_p", tlogs_p, logs_p), ("m_q", tm_q, m_q),
                           ("logs_q", tlogs_q, logs_q), ("pitch", tpitch, pitch),
                           ("energy", tenergy, energy), ("l_length", tl, l_length), ("o", to, o)):
            _close(a, r, name)
    assert np.abs(np.asarray(o)).mean() > 1e-3


def test_neg_cent_matches_jax_terms(models):
    rng = np.random.default_rng(22)
    z_p, m_p, logs_p = (rng.standard_normal(s).astype(np.float32)
                        for s in ((2, 30, 8), (2, 10, 8), (2, 10, 8)))
    s = np.exp(-2.0 * logs_p)
    want = (np.sum(-0.5 * np.log(2 * np.pi) - logs_p, -1)[:, None, :]
            + np.einsum("byc,bxc->byx", -0.5 * z_p ** 2, s)
            + np.einsum("byc,bxc->byx", z_p, m_p * s)
            + np.sum(-0.5 * m_p ** 2 * s, -1)[:, None, :])
    got = neg_cent(*(torch.from_numpy(a) for a in (z_p, m_p, logs_p)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_infer_matches_jax_at_noise_zero(models):
    """noise_scale = noise_scale_w = 0: lengths, masks and the alignment
    equal, the waveform to atol 1e-4 (flow reverse and decoder on K2's and
    K1's plain versions)."""
    jcfg, jm, params, port = models
    rng = np.random.default_rng(23)
    x = rng.integers(1, N_VOCAB, (2, 12))
    x_len, sid = np.array([12, 5]), np.array([2, 0])
    want = jax.jit(lambda p: jm.apply({"params": p}, x, x_len, sid, noise_scale=0.0,
                                      noise_scale_w=0.0, length_scale=1.7,
                                      max_frames=90, rng=jax.random.PRNGKey(24),
                                      method=JaxTTS.infer))(params)
    o, attn, y_mask, (z, z_p, m_p, logs_p) = want
    got = port.infer(torch.from_numpy(x), torch.from_numpy(x_len), torch.from_numpy(sid),
                     noise_scale=0.0, noise_scale_w=0.0, length_scale=1.7, max_frames=90)
    to, tattn, tym, (tz, tz_p, tm_p, tlogs_p) = got
    np.testing.assert_array_equal(tym.numpy(), np.asarray(y_mask))
    np.testing.assert_array_equal(tattn.numpy(), np.asarray(attn))
    assert 0 < np.asarray(y_mask).sum() < 180
    for name, a, r in (("m_p", tm_p, m_p), ("z_p", tz_p, z_p), ("z", tz, z)):
        _close(a, r, name)
    assert to.shape == (2, 90 * 512, 1) and np.abs(np.asarray(o)).mean() > 1e-3
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-4, rtol=0)


def test_infer_injected_draws_match_jax(models):
    """noise 0.667 / 0.8 with JAX's SDP and prior draws injected."""
    jcfg, jm, params, port = models
    rng = np.random.default_rng(25)
    x = rng.integers(1, N_VOCAB, (1, 8))
    key = jax.random.PRNGKey(26)
    o, attn, y_mask, (_, z_p, _, _) = jax.jit(lambda p: jm.apply(
        {"params": p}, x, np.array([8]), np.array([1]), noise_scale=0.667, noise_scale_w=0.8,
        max_frames=64, rng=key, method=JaxTTS.infer))(params)
    r_dur, r_prior = jax.random.split(key)
    noise_w = np.array(jax.random.normal(r_dur, (1, 8, 2)))
    eps = np.array(jax.random.normal(r_prior, (1, 64, 8)))
    to, tattn, tym, (_, tz_p, _, _) = port.infer(
        torch.from_numpy(x), torch.tensor([8]), torch.tensor([1]), noise_scale=0.667,
        noise_scale_w=0.8, max_frames=64, noise_w=torch.from_numpy(noise_w),
        eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(tym.numpy(), np.asarray(y_mask))
    np.testing.assert_array_equal(tattn.numpy(), np.asarray(attn))
    _close(tz_p, z_p, "z_p")
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-4, rtol=0)


def test_voice_conversion_matches_jax(models):
    jcfg, jm, params, port = models
    rng = np.random.default_rng(27)
    spec = np.abs(rng.standard_normal((2, 24, jcfg.data.spec_channels))).astype(np.float32)
    lens, src, tgt = np.array([24, 17]), np.array([1, 3]), np.array([2, 0])
    key = jax.random.PRNGKey(28)
    o, y_mask, (z, z_p, z_hat) = jax.jit(lambda p: jm.apply(
        {"params": p}, spec, lens, src, tgt, rng=key, method=JaxTTS.voice_conversion))(params)
    eps = np.array(jax.random.normal(key, np.asarray(z).shape))
    to, tym, (tz, tz_p, tz_hat) = port.voice_conversion(
        torch.from_numpy(spec), torch.from_numpy(lens), torch.from_numpy(src),
        torch.from_numpy(tgt), eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(tym.numpy(), np.asarray(y_mask))
    m = np.asarray(y_mask)
    for name, a, r in (("z", tz, z), ("z_p", tz_p, z_p), ("z_hat", tz_hat, z_hat)):
        np.testing.assert_allclose(a.numpy() * m, np.asarray(r) * m, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-4, rtol=0)


def test_tts_state_dict_names_are_jax_tree(models):
    """Every leaf of JAX's tree has its port parameter and no port
    parameter is left out; flax's nn.LayerNorm scale becomes weight."""
    _, _, params, port = models
    sd = params_from_jax(params)
    assert set(sd) == set(port.state_dict())
    assert "pitch_predictor.layer_0.norm.weight" in sd
    assert "duration_predictor.post_flow_3.convs.sep_2.weight" in sd

