"""The port's preload path (data/preload.py) == the JAX package's.

* `dump_hubert_features` with the port's HuBERT and with JAX's, on shared
  random HuBERT weights (`params_from_jax` of the generator's
  `enc_p.hubert` subtree), from the smoothed source: the same file names,
  and features within tests/test_torch_hubert.py's tolerance (atol 1e-4,
  rtol 1e-3: float32 sums in another order through the STFT -> iSTFT
  smoothing and the transformer).
* In the compute dtype: a bf16 dump (the dtype given, or a bf16 module's
  own) == JAX's bf16 dump (`dtype=jnp.bfloat16`, what `fp16_run` selects)
  to 2e-2 of the largest feature (measured 7.9e-3; JAX's own bf16 dump
  is 7.0e-3 from its float32 one), and away from the float32 dump.
* `sample_shift` draws JAX's shift for every (seed, epoch, index).
* A missing dump raises FileNotFoundError.
* One `TrainStep` on a preload batch (the port's dataset and collate,
  hubert_features included) == JAX's `make_train_step` on the same batch,
  with JAX's draws replayed as in tests/test_torch_train_step.py: every
  metric to rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import TINY_HUBERT, make_corpus
from tests.test_torch_train_step import CFG as STEP_CFG
from tests.test_torch_train_step import _draw, _jax_draws
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.data.dataset import VoiceConversionDataset as JaxDataset
from vcvits_tpu.data.preload import PreloadVoiceConversionDataset as JaxPreload
from vcvits_tpu.data.preload import dump_hubert_features as jax_dump
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.state import create_train_state
from vcvits_tpu.train.step import init_params, make_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.data.collate import bucket_lengths, collate, pick_bucket
from vcvits_tpu_torch.data.dataset import VoiceConversionDataset
from vcvits_tpu_torch.data.loader import to_device
from vcvits_tpu_torch.data.preload import (
    PreloadVoiceConversionDataset, dump_hubert_features, feature_file)
from vcvits_tpu_torch.models.hubert import HubertConfig, HubertModel
from vcvits_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)


def _cfg_dict(tmp):
    d = {k: dict(v) for k, v in STEP_CFG.items()}
    d["data"].update(length_buckets=[0.5], cache_dir=str(tmp / "cache"))
    return d


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preload")
    fl = make_corpus(tmp)
    d = _cfg_dict(tmp)
    cfg, jcfg = Config.from_dict(d), JaxConfig.from_dict(d)
    bucket = bucket_lengths(cfg.data)[0]
    ty = bucket * 3
    shape_batch = {"x_wav": np.zeros((2, bucket), np.float32),
                   "x_wav_lengths": np.full(2, bucket, np.int32),
                   "x_pitch": np.ones((2, bucket // 320), np.int32),
                   "y_wav": np.zeros((2, ty), np.float32),
                   "y_wav_lengths": np.full(2, ty, np.int32), "sid": np.array([1, 5], np.int32)}
    hub = JaxHubertConfig(**TINY_HUBERT)
    g_shapes, d_shapes = jax.eval_shape(
        lambda: init_params(jcfg, jax.random.PRNGKey(0), shape_batch, hubert_cfg=hub))
    rng = np.random.default_rng(2)
    g_params, d_params = (jax.tree.map(lambda s: _draw(rng, s.shape), t)
                          for t in (g_shapes, d_shapes))
    port_hubert = HubertModel(HubertConfig(**TINY_HUBERT))
    port_hubert.load_state_dict(params_from_jax(g_params["enc_p"]["hubert"]))

    port_ds = VoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / "port"))
    jax_ds = JaxDataset(fl, jcfg.data, cache_dir=str(tmp / "jax"))
    n_port = dump_hubert_features(port_ds, cfg, port_hubert, batch_size=2, device="cpu")
    n_jax = jax_dump(jax_ds, jcfg, g_params["enc_p"]["hubert"], hubert_cfg=hub, batch_size=2,
                     dtype=jnp.float32)
    return tmp, fl, cfg, jcfg, g_params, d_params, (n_port, n_jax)


def test_dumps_match_jax(setup):
    tmp, fl, cfg, jcfg, _, _, (n_port, n_jax) = setup
    assert n_port == n_jax == 4
    port = PreloadVoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / "port"))
    ref = JaxPreload(fl, jcfg.data, cache_dir=str(tmp / "jax"))
    for i in range(len(ref)):
        assert feature_file(port, i).replace(str(tmp / "port"), "") == \
            ref.feature_file(i).replace(str(tmp / "jax"), "")
        got, want = port.get_item(i)["hubert_features"], ref.get_item(i)["hubert_features"]
        assert got.shape == want.shape == (7200 // 320, TINY_HUBERT["hidden_size"])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3, err_msg=f"item {i}")
    # nothing left to dump
    assert dump_hubert_features(VoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / "port")),
                                cfg, HubertModel(HubertConfig(**TINY_HUBERT)), device="cpu") == 0


def test_dump_in_the_compute_dtype_matches_jax(setup):
    tmp, fl, cfg, jcfg, g_params, _, _ = setup
    hub = JaxHubertConfig(**TINY_HUBERT)
    jax_ds = JaxDataset(fl, jcfg.data, cache_dir=str(tmp / "jax_bf16"))
    assert jax_dump(jax_ds, jcfg, g_params["enc_p"]["hubert"], hubert_cfg=hub, batch_size=2,
                    dtype=jnp.bfloat16) == 4
    weights = params_from_jax(g_params["enc_p"]["hubert"])
    fp32 = HubertModel(HubertConfig(**TINY_HUBERT))
    fp32.load_state_dict(weights)
    bf16 = HubertModel(HubertConfig(**TINY_HUBERT), dtype=torch.bfloat16)
    bf16.load_state_dict(weights)
    for name, module, dtype in (("given", fp32, torch.bfloat16), ("own", bf16, None)):
        ds = VoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / name))
        assert dump_hubert_features(ds, cfg, module, batch_size=2, device="cpu",
                                    dtype=dtype) == 4
    ref = JaxPreload(fl, jcfg.data, cache_dir=str(tmp / "jax_bf16"))
    f32 = PreloadVoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / "port"))
    for name in ("given", "own"):
        port = PreloadVoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / name))
        for i in range(len(ref)):
            got, want = port.get_item(i)["hubert_features"], ref.get_item(i)["hubert_features"]
            assert got.dtype == np.float32
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=0, err_msg=name)
            assert np.abs(got - f32.get_item(i)["hubert_features"]).max() > 1e-3 * scale


def test_sample_shift_matches_jax(setup):
    tmp, fl, cfg, jcfg, _, _, _ = setup
    port = PreloadVoiceConversionDataset(fl, cfg.data, random_shift=True, shift_seed=77)
    ref = JaxPreload(fl, jcfg.data, random_shift=True, shift_seed=77)
    for epoch in (0, 1, 5):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [port.sample_shift(i) for i in range(300)]
        assert got == [ref.sample_shift(i) for i in range(300)]
        assert -12 <= min(got) < 0 < max(got) <= 12


def test_missing_dump_raises(setup, tmp_path):
    _, fl, cfg, _, _, _, _ = setup
    ds = PreloadVoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="precomputed HuBERT"):
        ds.get_item(0)


def test_preload_train_step_matches_jax(setup):
    tmp, fl, cfg, jcfg, g_params, d_params, _ = setup
    ds = PreloadVoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp / "port"),
                                       shuffle_seed=None)
    items = [ds.get_item(i) for i in range(2)]
    batch = collate(items, cfg.data, pick_bucket(len(items[0]["x_wav"]),
                                                 bucket_lengths(cfg.data)))
    assert batch["hubert_features"].shape == (2, 32, TINY_HUBERT["hidden_size"])

    key = jax.random.PRNGKey(11)
    state = create_train_state(jcfg, g_params, d_params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, want = jax.jit(make_train_step(jcfg, hubert_cfg=JaxHubertConfig(**TINY_HUBERT)))(
        state, jbatch, key)

    port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT),
                     g_state=params_from_jax(g_params), d_state=disc_params_from_jax(d_params))
    got = port(to_device(batch, "cpu"), _jax_draws(key, batch, jcfg))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
