"""Reference-layout checkpoints <-> the port (convert/vcvits_torch.py,
convert/export_torch.py, convert/hubert_torch.py, cli/convert_checkpoint.py).

* A reference-layout state dict written by JAX's exporter
  (`export_generator`, `export_discriminators`, `export_lightning_checkpoint`)
  on random JAX parameters converts into tensors exactly equal to
  `params_from_jax` / `disc_params_from_jax` of the same parameters, and
  loads into the port's modules (strict).
* A standalone hub-vocoder decoder and a plain (not weight-normed) conv
  convert exactly as JAX's converter does.
* HuBERT: a synthetic fairseq-layout state dict (weight-normed positional
  conv, and the transformers naming) converts exactly as JAX's converter
  does; `load_fairseq_checkpoint` reads a `.pt`.
* The port's export followed by its import is the identity, for the
  generator, the discriminators and HuBERT.
* `python -m vcvits_tpu_torch.cli.convert_checkpoint` in both directions on
  a synthetic `.ckpt`: the imported checkpoint directory holds the
  converted weights at the chosen step, and exporting it again gives back
  the same tensors.
"""

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.convert import export_torch as jax_export
from vcvits_tpu.convert import hubert_torch as jax_hubert
from vcvits_tpu.convert import vcvits_torch as jax_convert
from vcvits_tpu.models.discriminators import MultiPeriodDiscriminator as JaxMPD
from vcvits_tpu.models.discriminators import MultiScaleDiscriminator as JaxMSD
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.models.hubert import HubertModel as JaxHubert
from vcvits_tpu.models.synthesizer import SynthesizerSVC as JaxSynth
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert import export_torch, hubert_torch, vcvits_torch
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.models.discriminators import Discriminators
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.models.layers import init_weights
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

torch.set_num_threads(1)

HUB = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=2,
           num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {
    "train": {"segment_size": 2048},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 4, "num_pitch": 64},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0,
              "hubert_channels": 16, "num_pitch": 64, "gin_channels": 4,
              "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7],
              "resblock_dilation_sizes": [[1, 3], [1, 3]],
              "multi_period_discriminator_periods": [2, 3]},
}


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                        shapes)


def _assert_sd_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def jax_params():
    jcfg = JaxConfig.from_dict(CFG)
    jm = JaxSynth.from_config(jcfg).clone(hubert_cfg=JaxHubertConfig(**HUB))
    t, t_spec = 5120, 30
    shapes = jax.eval_shape(lambda: jm.init(  # the training forward creates every subtree
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        np.zeros((1, t), np.float32), np.array([t]), np.zeros((1, t // 320), np.int32),
        np.zeros((1, t_spec, jcfg.data.spec_channels), np.float32), np.array([t_spec]),
        np.array([0])))["params"]
    wav = np.zeros((1, 2048, 1), np.float32)
    periods = tuple(jcfg.model.multi_period_discriminator_periods)
    d_shapes = {
        "mpd": jax.eval_shape(lambda: JaxMPD(periods=periods).init(
            jax.random.PRNGKey(0), wav, wav))["params"],
        "msd": jax.eval_shape(lambda: JaxMSD().init(jax.random.PRNGKey(1), wav, wav))["params"]}
    return jcfg, _random_tree(shapes, 0), _random_tree(d_shapes, 1)


def test_jax_exported_generator_loads_bit_equal(jax_params):
    jcfg, g, _ = jax_params
    sd = jax_export.export_generator(g, jcfg)
    got = vcvits_torch.convert_generator(sd, Config.from_dict(CFG),
                                         hubert_cfg=HubertConfig(**HUB))
    _assert_sd_equal(got, params_from_jax(g))
    model = SynthesizerSVC.from_config(Config.from_dict(CFG), device="cpu", seed=None,
                                       hubert_cfg=HubertConfig(**HUB))
    model.load_state_dict(got)  # strict: the port's every parameter, nothing else


def test_jax_exported_discriminators_load_bit_equal(jax_params):
    jcfg, _, d = jax_params
    got = vcvits_torch.convert_discriminators(jax_export.export_discriminators(d, jcfg),
                                              Config.from_dict(CFG))
    _assert_sd_equal(got, disc_params_from_jax(d))
    Discriminators.from_config(Config.from_dict(CFG)).load_state_dict(got)


def test_jax_written_lightning_checkpoint_loads_bit_equal(jax_params, tmp_path):
    jcfg, g, d = jax_params
    path = str(tmp_path / "ref.ckpt")
    jax_export.export_lightning_checkpoint(path, g, jcfg, d_params=d)
    gen, disc = vcvits_torch.convert_lightning_checkpoint(path, Config.from_dict(CFG),
                                                          hubert_cfg=HubertConfig(**HUB))
    _assert_sd_equal(gen, params_from_jax(g))
    _assert_sd_equal(disc, disc_params_from_jax(d))


def test_hub_vocoder_and_plain_convs_convert_as_jax(jax_params):
    """A standalone vocoder (conv_pre/ups/resblocks/conv_post, no cond):
    JAX's convert_hifigan_generator and the port's agree exactly, the zero
    cond included; so do plain convs wrapped as weight norm (g = ||W||)."""
    jcfg, g, _ = jax_params
    sd = {k[len("dec."):]: v for k, v in jax_export.export_generator(g, jcfg).items()
          if k.startswith("dec.") and not k.startswith("dec.cond")}
    for name in ("conv_pre", "ups.1", "resblocks.2.convs1.0"):  # plain weights
        v, gn = sd.pop(f"{name}.weight_v"), sd.pop(f"{name}.weight_g")
        sd[f"{name}.weight"] = (v * gn / np.linalg.norm(
            v.reshape(v.shape[0], -1), axis=1).reshape(-1, *[1] * (v.ndim - 1))).astype(np.float32)
    want = params_from_jax(jax_convert.convert_hifigan_generator(sd, jcfg))
    got = vcvits_torch.convert_hifigan_generator(sd, Config.from_dict(CFG))
    _assert_sd_equal(got, want)
    assert not got["cond.weight"].any()


@pytest.fixture(scope="module")
def hubert_sd():
    """A fairseq-layout HuBERT state dict from JAX's exporter on random
    parameters, its positional conv weight-normed (dim 2) as fairseq's is."""
    shapes = jax.eval_shape(lambda: JaxHubert(JaxHubertConfig(**HUB)).init(
        jax.random.PRNGKey(0), np.zeros((1, 2640), np.float32)))["params"]
    sd = jax_export.export_hubert_state_dict(_random_tree(shapes, 2))
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_v"] = w
    sd["encoder.pos_conv.0.weight_g"] = (np.random.default_rng(3).standard_normal(
        (1, 1, w.shape[2])) * 0.5).astype(np.float32)
    return sd


def _transformers_naming(sd):
    ren = {".self_attn.": ".attention.", ".self_attn_layer_norm.": ".layer_norm.",
           ".fc1.": ".feed_forward.intermediate_dense.",
           ".fc2.": ".feed_forward.output_dense."}
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder.layers."):
            for a, b in ren.items():
                k = k.replace(a, b)
        k = (k.replace("feature_extractor.conv_layers.0.2.",
                       "feature_extractor.conv_layers.0.layer_norm.")
             .replace(".0.weight", ".conv.weight") if k.startswith("feature_extractor") else k)
        if k.startswith("layer_norm."):
            k = "feature_projection." + k
        k = k.replace("post_extract_proj.", "feature_projection.projection.")
        k = k.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
        out[k] = v
    return out


@pytest.mark.parametrize("naming", ["fairseq", "transformers"])
def test_hubert_converter_matches_jax(hubert_sd, naming):
    sd = hubert_sd if naming == "fairseq" else _transformers_naming(hubert_sd)
    want = params_from_jax(jax_hubert.convert_hubert_state_dict(sd, JaxHubertConfig(**HUB)))
    got = hubert_torch.convert_hubert_state_dict(sd, HubertConfig(**HUB))
    _assert_sd_equal(got, want)


def test_hubert_fairseq_checkpoint_loads_and_round_trips(hubert_sd, tmp_path):
    path = str(tmp_path / "hubert.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in hubert_sd.items()},
                "cfg": {"note": "not a tensor"}}, path)
    got = hubert_torch.load_fairseq_checkpoint(path, HubertConfig(**HUB))
    _assert_sd_equal(got, hubert_torch.convert_hubert_state_dict(hubert_sd, HubertConfig(**HUB)))
    back = hubert_torch.convert_hubert_state_dict(hubert_torch.export_hubert_state_dict(got),
                                                  HubertConfig(**HUB))
    _assert_sd_equal(back, got)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_port_export_then_import_is_identity(resblock):
    cfg = Config.from_dict({**CFG, "model": {**CFG["model"], "resblock": resblock}})
    model = SynthesizerSVC.from_config(cfg, device="cpu", seed=4, hubert_cfg=HubertConfig(**HUB))
    with torch.no_grad():  # every value its own: no zero post, no g = ||v||
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    gen = model.state_dict()
    back = vcvits_torch.convert_generator(export_torch.export_generator(gen, cfg), cfg,
                                          hubert_cfg=HubertConfig(**HUB))
    _assert_sd_equal(back, gen)
    disc = init_weights(Discriminators.from_config(cfg), 5).state_dict()
    _assert_sd_equal(vcvits_torch.convert_discriminators(
        export_torch.export_discriminators(disc, cfg), cfg), disc)


def test_cli_convert_checkpoint_both_directions(jax_params, tmp_path, monkeypatch):
    """Import: a reference .ckpt -> a port checkpoint directory (step 7,
    fresh optimizers) and config.json; export: that directory -> a .ckpt
    holding the input's tensors again."""
    import json

    from vcvits_tpu_torch.cli import convert_checkpoint as cli
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    tiny = HubertConfig(**HUB)
    monkeypatch.setattr(synthesizer, "hubert_config_for", lambda channels: tiny)
    monkeypatch.setattr(vcvits_torch, "hubert_config_for", lambda channels: tiny)
    jcfg, g, d = jax_params
    src = str(tmp_path / "ref.ckpt")
    ref = jax_export.export_lightning_checkpoint(src, g, jcfg, d_params=d)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(CFG))
    workdir = tmp_path / "converted"
    cli.main([src, "-c", str(cfg_path), "--workdir", str(workdir), "--step", "7"])
    saved = CheckpointManager(str(workdir / "checkpoints")).restore()
    assert saved["step"] == 7 and (workdir / "config.json").exists()
    _assert_sd_equal(saved["gen"], params_from_jax(g))
    _assert_sd_equal(saved["disc"], disc_params_from_jax(d))
    out = str(tmp_path / "back.ckpt")
    cli.main(["--export", out, "--workdir", str(workdir), "-c", str(cfg_path)])
    back = torch.load(out, map_location="cpu", weights_only=True)["state_dict"]
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert torch.equal(back[k], v), k
