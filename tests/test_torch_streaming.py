"""The port's StreamingConverter (vcvits_tpu_torch/streaming.py) against
JAX's, both modes.

tests/test_streaming.py's tiny configuration on shared random weights
(numpy draws over JAX's parameter shapes, carried over by params_from_jax),
the port on the CPU. At noise_scale=0 the two are deterministic: windowed
(every window through convert_array, K2's and K1's plain versions here)
and incremental (the cached-state flow + decoder) streams of the same
source, pushed in awkward 3333-sample pieces, agree with JAX's to atol
1e-4 (the tolerance of the port's convert_array against JAX's,
tests/test_torch_synthesizer.py). The incremental stream has the exact
length floor(true_len * 48000 / (16000 * hop)) * hop. At noise_scale=1 the
incremental noise of a global frame does not depend on the chunking.
"""

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.infer import VoiceConverter as JaxVoiceConverter
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth
from vcvits_tpu.streaming import StreamingConverter as JaxStreamingConverter
from vcvits_tpu_torch import streaming as port_streaming
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.streaming import StreamingConverter, _frame_noise

torch.set_num_threads(1)

HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {
    "train": {"segment_size": 2048},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 4, "num_pitch": 64},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0, "hubert_channels": 16,
              "num_pitch": 64, "gin_channels": 4, "upsample_initial_channel": 32,
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]]},
}
ATOL = 1e-4
SR = 16000


@pytest.fixture(scope="module")
def converters():
    """(JAX VoiceConverter, the port's VoiceConverter on the CPU), same weights."""
    jcfg = JaxConfig.from_dict(CFG)
    jm = JaxSynth.from_config(jcfg).clone(hubert_cfg=JaxHubertConfig(**HUBERT))
    shapes = jax.eval_shape(lambda: jm.init(  # the training forward creates every subtree
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        np.zeros((1, 2560), np.float32), np.array([2560]), np.zeros((1, 8), np.int32),
        np.zeros((1, 10, 513), np.float32), np.array([10]), sid=np.array([1]),
        rng=jax.random.PRNGKey(2)))["params"]
    rng = np.random.default_rng(0)

    def draw(path, s):
        # weight-norm gains 1.5 and biases 0.02 x N(0, 1), the rest 0.2: the
        # tiny decoder then gives a signal (std about 0.2) that depends on
        # the input and the speaker, neither flat nor saturated
        name = str(getattr(path[-1], "key", path[-1]))
        scale = 1.5 if name == "g" else 0.02 if name == "bias" else 0.2
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    jvc = JaxVoiceConverter(jcfg, params, hubert_cfg=JaxHubertConfig(**HUBERT))
    port = VoiceConverter.from_params(Config.from_dict(CFG), params, device="cpu",
                                      hubert_cfg=HubertConfig(**HUBERT))
    return jvc, port


def _source(seconds=1.28):
    t = np.arange(int(SR * seconds)) / SR
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
            ).astype(np.float32)


def _run(conv, src, piece=3333):
    out = []
    for start in range(0, len(src), piece):
        out.extend(conv.push(src[start:start + piece]))
    out.extend(conv.flush())
    return np.concatenate(out)


@pytest.mark.parametrize("incremental", [False, True], ids=["windowed", "incremental"])
def test_matches_jax_at_noise_zero(converters, incremental):
    jvc, port = converters
    src = _source()
    kw = dict(speaker_id=1, chunk_seconds=0.32, context_seconds=0.16, noise_scale=0.0,
              incremental=incremental)
    ref = _run(JaxStreamingConverter(jvc, **kw), src)
    sc = StreamingConverter(port, **kw)
    got = _run(sc, src)
    assert got.shape == ref.shape
    assert np.std(ref) > 0.05  # neither silent nor flat
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if incremental:
        hop = port.cfg.data.hop_length
        assert len(got) == (len(src) * 48000 // (SR * hop)) * hop  # the exact length contract
        assert sc._sfd.delay_samples > 0
    else:
        assert abs(len(got) - 3 * len(src)) <= sc.xfade + 3


def test_reset_and_set_speaker(converters):
    """A reset converter re-targeted to another speaker gives what a fresh
    converter of that speaker gives, in both modes."""
    _, port = converters
    src = _source(0.8)
    for incremental in (False, True):
        kw = dict(chunk_seconds=0.32, context_seconds=0.16, noise_scale=0.0,
                  incremental=incremental)
        sc = StreamingConverter(port, speaker_id=0, **kw)
        first = _run(sc, src)
        list(sc.push(src[:7000]))  # a half-done stream, then dropped
        sc.reset()
        assert len(sc._buf) == 0 and sc._tail is None
        sc.set_speaker(2)
        again = _run(sc, src)
        fresh = _run(StreamingConverter(port, speaker_id=2, **kw), src)
        np.testing.assert_array_equal(again, fresh)
        assert again.shape == first.shape and not np.array_equal(again, first)


def test_incremental_noise_does_not_depend_on_chunking(converters, monkeypatch):
    """noise_scale=1: every global frame gets the same noise row whether the
    stream runs in 0.32 s or 0.48 s chunks, and the output of a stream does
    not depend on the push sizes."""
    _, port = converters
    runs = []  # per run: {global frame: its noise row}

    def recording(seed, start, n, c):
        rows = _frame_noise(seed, start, n, c)
        runs[-1].update({start + i: rows[i] for i in range(n)})
        return rows

    monkeypatch.setattr(port_streaming, "_frame_noise", recording)
    src = _source(1.6)
    outs = []
    for chunk in (0.32, 0.48):
        runs.append({})
        sc = StreamingConverter(port, speaker_id=1, chunk_seconds=chunk, context_seconds=0.16,
                                noise_scale=1.0, rng_seed=5, incremental=True)
        outs.append(_run(sc, src, piece=5000))
    a, b = runs
    common = sorted(set(a) & set(b))
    assert len(common) >= 90
    for f in common:
        np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(_frame_noise(5, 0, 30, 8),
                                  np.concatenate([_frame_noise(5, 0, 11, 8),
                                                  _frame_noise(5, 11, 19, 8)]))
    assert not np.array_equal(_frame_noise(5, 0, 4, 8), _frame_noise(6, 0, 4, 8))
    runs.append({})
    sc = StreamingConverter(port, speaker_id=1, chunk_seconds=0.32, context_seconds=0.16,
                            noise_scale=1.0, rng_seed=5, incremental=True)
    np.testing.assert_array_equal(_run(sc, src, piece=3333), outs[0])
