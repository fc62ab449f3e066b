"""The TTS train step and its data, port == JAX: TTSTrainStep against
make_tts_train_step in float32, the TTS dataset and collate, and
tts_train_state_from_jax.

tests/test_tts_train.py's tiny configuration and batch on shared random
weights (carried over with params_from_jax / disc_params_from_jax). The
JAX step always drops out, so flax's Dropout is made the identity for the
JAX side here, and the port's step runs with dropout=False. JAX's draws
are replayed from its key splits (tts_step.py: the step key -> (model,
dropout); synthesizer_tts.py: model -> (posterior, SDP, slice);
posterior.py: normal eps; the SDP's normal e_q; masking.py: uniform
starts) and injected. The port's targets go through K3's plain version,
JAX's through its XLA rfft. float32 on the CPU.

Held: every metric to rtol 1e-3 (atol 1e-6 near zero); the updated
parameters of both halves to rtol 1e-3 wherever Adam's first moment is
above `SIGN_BAND` of the tensor's largest, and elsewhere to the first
step's own bound 2 lr (Adam's first step moves a parameter by about
lr * sign(g), and a sign that is rounding noise may differ; see
tests/test_torch_train_step.py). JAX's TTS step updates D on the G step's
own output, so the D half sees the same input on both sides and needs no
separate run.
"""

import random

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import _adam_mu, _draw
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.data import tts_dataset as jax_tts_dataset
from vcvits_tpu.train.state import create_train_state
from vcvits_tpu.train.tts_step import init_tts_params, make_tts_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import (
    disc_params_from_jax, params_from_jax, tts_train_state_from_jax)
from vcvits_tpu_torch.data import tts_dataset
from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep
from vcvits_tpu_torch.utils.audio_io import write_wav

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_VOCAB = 40
CFG = {
    "train": {"segment_size": 2048, "batch_size": 2, "steps_per_epoch": 10,
              "disc_time_fold": False},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1,
              "gin_channels": 4, "upsample_initial_channel": 32,
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "multi_period_discriminator_periods": [2, 3]},
}
RTOL, ATOL = 1e-3, 1e-6
SIGN_BAND = 1e-5


def tts_batch():
    g = np.random.default_rng(0)
    b, t_x, ty = 2, 10, 15360
    return {
        "text": g.integers(1, N_VOCAB, (b, t_x)).astype(np.int64),
        "text_lengths": np.array([10, 7], np.int32),
        "y_wav": (g.standard_normal((b, ty)) * 0.1).astype(np.float32),
        "y_wav_lengths": np.array([ty, ty - 2048], np.int32),
        "pitch": np.abs(g.standard_normal((b, ty // 512)) * 100).astype(np.float32),
        "sid": np.array([0, 3], np.int32),
    }


def jax_tts_draws(key, batch, cfg, dtype=jnp.float32):
    """The posterior eps, the SDP's e_q and the segment starts JAX draws
    from the step key `key` (eps in the compute dtype, as posterior.py)."""
    b, t_x = batch["text"].shape
    hop = cfg.data.hop_length
    t_spec = batch["y_wav"].shape[1] // hop
    seg = cfg.train.segment_size // hop
    lens = jnp.asarray(batch["y_wav_lengths"]) // hop
    r_model, _ = jax.random.split(key)
    r_post, r_dur, r_slice = jax.random.split(r_model, 3)
    eps = jax.random.normal(r_post, (b, t_spec, cfg.model.inter_channels), dtype)
    e_q = jax.random.normal(r_dur, (b, t_x, 2))
    u = jax.random.uniform(r_slice, (b,))
    ids = jnp.floor(u * jnp.maximum(lens - seg + 1, 1).astype(u.dtype)).astype(jnp.int32)
    to = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                             else a))
    return TTSStepDraws(eps=to(eps).to(torch.bfloat16 if dtype == jnp.bfloat16
                                       else torch.float32), e_q=to(e_q), ids_str=to(ids))


def no_jax_dropout(monkeypatch):
    """flax's Dropout as the identity, for the JAX step's trace."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)


def jax_weights(jcfg, batch, seed=1):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_shapes, d_shapes = jax.eval_shape(
        lambda: init_tts_params(jcfg, jax.random.PRNGKey(0), jbatch, n_vocab=N_VOCAB))
    rng = np.random.default_rng(seed)
    return tuple(jax.tree.map(lambda s: _draw(rng, s.shape), t) for t in (g_shapes, d_shapes))


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        jcfg, cfg = JaxConfig.from_dict(CFG), Config.from_dict(CFG)
        batch = tts_batch()
        g_params, d_params = jax_weights(jcfg, batch)
        state = create_train_state(jcfg, g_params, d_params, freeze_hubert=False)
        key = jax.random.PRNGKey(7)
        step = jax.jit(make_tts_train_step(jcfg, n_vocab=N_VOCAB))
        state1, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        metrics = {k: float(v) for k, v in metrics.items()}
    port = TTSTrainStep(cfg, device="cpu", g_state=params_from_jax(g_params),
                        d_state=disc_params_from_jax(d_params), n_vocab=N_VOCAB, dropout=False)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = port(tbatch, jax_tts_draws(key, batch, jcfg))
    return state1, metrics, port, {k: float(v) for k, v in got.items()}


def test_tts_step_metrics_match_jax(run):
    _, metrics, _, got = run
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("loss/g/dur", "loss/g/pitch", "loss/g/energy", "grad_norm_g", "grad_norm_d"):
        assert got[k] > 0, k


@pytest.mark.parametrize("side", ["g", "d"])
def test_tts_step_updated_params_match_jax(run, side):
    state1, _, port, _ = run
    if side == "g":
        module, conv = port.gen, params_from_jax
        mu, want_tree = _adam_mu(state1.g_opt_state), state1.g_params
    else:
        module, conv = port.disc, disc_params_from_jax
        mu, want_tree = _adam_mu(state1.d_opt_state), state1.d_params
    mu, want = conv(mu), conv(want_tree)
    params = dict(module.named_parameters())
    assert set(want) == set(params) == set(mu)
    lr = port.schedule(0)
    for name, w in want.items():
        got = params[name].detach()
        tiny = mu[name].abs() <= SIGN_BAND * mu[name].abs().max().item()
        if name.endswith(".conv_k.bias"):  # zero gradient in exact arithmetic
            tiny = torch.ones_like(tiny)
        np.testing.assert_allclose(got[~tiny].numpy(), w[~tiny].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        if tiny.any():
            assert (got[tiny] - w[tiny]).abs().max().item() <= 2 * lr * (1 + RTOL) + ATOL, name


def test_tts_step_launch_path_and_state(run):
    """The step counts, the checkpoint layout it shares with TrainStep,
    and every generator parameter trained (MAS's path carries no
    gradient, the SDP and both predictors do)."""
    _, _, port, _ = run
    assert port.step == 1 and port.updates == 1
    state = port.state_dict()
    assert set(state) == {"step", "gen", "disc", "g_opt", "d_opt", "accum"}
    for n, p in port.gen.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, n


def test_tts_train_state_from_jax_resumes(run):
    """A JAX TTS state -> TTSTrainStep.load_state_dict: weights and Adam
    moments as JAX's."""
    state1, _, _, _ = run
    cfg = Config.from_dict(CFG)
    converted = tts_train_state_from_jax(jax.tree.map(np.asarray, state1), cfg)
    port = TTSTrainStep(cfg, device="cpu", n_vocab=N_VOCAB, dropout=False)
    port.load_state_dict(converted)
    assert port.step == 1
    mu = params_from_jax(_adam_mu(state1.g_opt_state))
    for name, p in port.gen.named_parameters():
        np.testing.assert_array_equal(port.g_opt.state[p]["exp_avg"].numpy(), mu[name].numpy())
    with pytest.raises(ValueError):
        tts_train_state_from_jax({**converted, "g_params": {"dec": {}}}, cfg)


def test_tts_step_refuses_bad_dtype():
    with pytest.raises(ValueError):
        TTSTrainStep(Config.from_dict(CFG), device="cpu", dtype=torch.float16)


# --------------------------------------------------------------- the data
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts_corpus")
    rng = np.random.default_rng(3)
    lines = []
    for i, (sr, sec) in enumerate(((22050, 0.7), (16000, 0.5), (48000, 1.1))):
        t = np.arange(int(sr * sec)) / sr
        wav = 0.3 * np.sin(2 * np.pi * (140 + 40 * i) * t) + 0.01 * rng.standard_normal(t.size)
        path = str(root / f"u{i}.wav")
        write_wav(path, wav.astype(np.float32), sr)
        lines.append(f"{path}|{i + 1}|Hello number {i}, Dr. Who!" if i != 1 else f"{path}|hi")
    fl = root / "train.txt"
    fl.write_text("\n".join(lines) + "\n")
    return str(fl), root


@pytest.mark.parametrize("add_blank", [False, True])
def test_tts_dataset_and_collate_equal_jax(corpus, add_blank):
    fl, root = corpus
    jcfg, cfg = JaxConfig.from_dict(CFG), Config.from_dict(CFG)
    tag = "b" if add_blank else "n"
    jds = jax_tts_dataset.TTSDataset(fl, jcfg.data, cache_dir=str(root / f"jc{tag}"),
                                     add_blank=add_blank)
    tds = tts_dataset.TTSDataset(fl, cfg.data, cache_dir=str(root / f"tc{tag}"),
                                 add_blank=add_blank)
    assert tds.items == jds.items
    assert tts_dataset.load_tts_filelist(fl) == jax_tts_dataset.load_tts_filelist(fl)
    j_items = [jds.get_item(i) for i in range(len(jds))]
    t_items = [tds.get_item(i) for i in range(len(tds))]
    for ji, ti in zip(j_items, t_items):
        assert set(ji) == set(ti)
        for k in ji:
            np.testing.assert_array_equal(np.asarray(ti[k]), np.asarray(ji[k]), err_msg=k)
            assert np.asarray(ti[k]).dtype == np.asarray(ji[k]).dtype, k
    # a cache written by JAX reads back in the port
    cross = tts_dataset.TTSDataset(fl, cfg.data, cache_dir=str(root / f"jc{tag}"),
                                   add_blank=add_blank)
    np.testing.assert_array_equal(cross.get_item(0)["pitch"], j_items[0]["pitch"])
    for bucket in (24000, 40960):  # crops at random hop-aligned offsets, and pads
        jb = jax_tts_dataset.collate_tts(j_items, jcfg.data, 12, bucket, random.Random(5))
        tb = tts_dataset.collate_tts(t_items, cfg.data, 12, bucket, random.Random(5))
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            assert tb[k].dtype == jb[k].dtype, k
