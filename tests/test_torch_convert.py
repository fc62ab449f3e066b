"""JAX parameter trees -> the port's state dicts, leaf by leaf.

Every leaf of a JAX generator tree (enc_q included) and of a JAX
discriminator tree lands on exactly one parameter of the port's module,
with the same number of values, and every port parameter is reached.

`train_state_from_jax` carries a whole JAX GANTrainState, two optax steps
in (non-zero Adam moments, count 2), into the port's checkpoint layout:
weights, mu / nu and the step exactly, HuBERT with no moments. One AdamW
step of the port from the carried state, on a given gradient, moves every
trainable parameter as optax's adamw update does, to rtol 1e-6 (the same
float32 formula with the bias corrections and the decay in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.state import create_train_state, exponential_epoch_schedule, make_optimizer
from vcvits_tpu.train.step import init_params
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import (
    disc_params_from_jax, params_from_jax, train_state_from_jax)
from vcvits_tpu_torch.models.discriminators import Discriminators
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {"train": {"segment_size": 2048},
       "data": {"filter_length": 1024, "win_length": 1024, "n_mel_channels": 8,
                "n_speakers": 8},
       "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
                 "n_heads": 2, "n_layers": 1, "hubert_channels": 16, "num_pitch": 64,
                 "gin_channels": 4, "upsample_initial_channel": 32,
                 "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1]],
                 "multi_period_discriminator_periods": [2, 3]}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def trees():
    batch = {"x_wav": np.zeros((1, 5120), np.float32), "x_wav_lengths": np.array([5120]),
             "x_pitch": np.zeros((1, 16), np.int32), "y_wav": np.zeros((1, 15360), np.float32),
             "y_wav_lengths": np.array([15360]), "sid": np.array([1])}
    return jax.eval_shape(lambda: init_params(JaxConfig.from_dict(CFG), jax.random.PRNGKey(0),
                                              batch, hubert_cfg=JaxHubertConfig(**HUBERT)))


@pytest.mark.parametrize("side", ["generator", "discriminators"])
def test_every_leaf_lands_on_one_parameter(trees, side):
    cfg = Config.from_dict(CFG)
    if side == "generator":
        tree = trees[0]
        module = SynthesizerSVC.from_config(cfg, device="cpu", seed=None,
                                            hubert_cfg=HubertConfig(**HUBERT))
        convert = params_from_jax
    else:
        tree = trees[1]
        module = Discriminators.from_config(cfg)
        convert = disc_params_from_jax
    leaves = dict(_leaves(tree))
    assert any(k.startswith("enc_q.") for k in leaves) or side != "generator"
    # a distinct value per leaf, to see where each one lands
    numbered = {}
    for i, (path, leaf) in enumerate(leaves.items()):
        numbered[path] = np.full(leaf.shape, float(i), np.float32)
    nested = {}
    for path, arr in numbered.items():
        node = nested
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr
    sd = convert(nested)
    params = dict(module.named_parameters())
    assert set(sd) == set(params)  # every parameter reached, nothing extra
    landed = {}
    for name, t in sd.items():
        vals = torch.unique(t)
        assert vals.numel() == 1 and t.shape == params[name].shape, name
        landed.setdefault(int(vals.item()), []).append(name)
    assert sorted(landed) == list(range(len(leaves)))
    assert all(len(names) == 1 for names in landed.values())
    module.load_state_dict(sd)


def _random_tree(tree, rng, scale):
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
                        tree)


@pytest.fixture(scope="module")
def jax_state(trees):
    """A JAX GANTrainState after two optax steps on random gradients, and
    the jitted update steps and gradients of a third."""
    jcfg = JaxConfig.from_dict(CFG)
    rng = np.random.default_rng(4)
    g_params, d_params = (_random_tree(t, rng, 0.1) for t in trees)
    state = create_train_state(jcfg, g_params, d_params)
    g_step = _jit_step(make_optimizer(jcfg, freeze_hubert=True))
    d_step = _jit_step(make_optimizer(jcfg, freeze_hubert=False))
    g_os, d_os = state.g_opt_state, state.d_opt_state
    for _ in range(2):
        g_grads, d_grads = _random_tree(g_params, rng, 1.0), _random_tree(d_params, rng, 1.0)
        g_params, g_os = g_step(g_grads, g_os, g_params)
        d_params, d_os = d_step(d_grads, d_os, d_params)
    state = state.replace(step=jnp.asarray(2, jnp.int32), g_params=g_params, g_opt_state=g_os,
                          d_params=d_params, d_opt_state=d_os)
    grads = (_random_tree(g_params, rng, 1.0), _random_tree(d_params, rng, 1.0))
    return jax.tree.map(np.asarray, state), (g_step, d_step), grads


def _jit_step(opt):
    """(grads, opt_state, params) -> (updated params, opt_state), jitted."""
    def step(grads, opt_state, params):
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state
    return jax.jit(step)


def _adam(opt_state):
    inner = opt_state.inner_state if hasattr(opt_state, "inner_state") else opt_state
    return next(s for s in inner if hasattr(s, "mu"))


def test_train_state_carries_weights_and_moments(jax_state):
    state, _, _ = jax_state
    got = train_state_from_jax(state, Config.from_dict(CFG))
    assert got["step"] == 2
    _assert_sd_equal(got["gen"], params_from_jax(state.g_params))
    _assert_sd_equal(got["disc"], disc_params_from_jax(state.d_params))
    for key, opt_state, convert in (("g_opt", state.g_opt_state, params_from_jax),
                                    ("d_opt", state.d_opt_state, disc_params_from_jax)):
        adam = _adam(opt_state)
        mu = convert({k: v for k, v in adam.mu.items()} if key == "d_opt" else
                     _without_hubert(adam.mu))
        nu = convert(_without_hubert(adam.nu)) if key == "g_opt" else convert(adam.nu)
        assert set(got[key]) == set(mu) and not any("hubert" in n.split(".") for n in got[key])
        for name, moments in got[key].items():
            assert torch.equal(moments["exp_avg"], mu[name]) and mu[name].abs().sum() > 0, name
            assert torch.equal(moments["exp_avg_sq"], nu[name]), name
            assert float(moments["step"]) == 2.0


def _without_hubert(tree):
    return {k: (_without_hubert(v) if hasattr(v, "items") else v)
            for k, v in tree.items() if k != "hubert"}


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_port_adamw_step_matches_optax(jax_state):
    from vcvits_tpu_torch.train.step import TrainStep

    state, (g_step, d_step), (g_grads, d_grads) = jax_state
    jcfg, cfg = JaxConfig.from_dict(CFG), Config.from_dict(CFG)
    port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT))
    port.load_state_dict(train_state_from_jax(state, cfg))
    lr = float(jnp.asarray(exponential_epoch_schedule(jcfg)(2), jnp.float32))
    port._set_lr(lr)
    want = {}
    for side, jit_step, grads, params, opt_state, convert in (
            ("gen", g_step, g_grads, state.g_params, state.g_opt_state, params_from_jax),
            ("disc", d_step, d_grads, state.d_params, state.d_opt_state, disc_params_from_jax)):
        new_params, _ = jit_step(grads, opt_state, params)
        want[side] = convert(jax.tree.map(np.asarray, new_params))
        module = port.gen if side == "gen" else port.disc
        g = convert(grads)
        for name, p in module.named_parameters():
            p.grad = g[name].clone()
    port.g_opt.step()
    port.d_opt.step()
    for side, module in (("gen", port.gen), ("disc", port.disc)):
        n = 0
        for name, p in module.named_parameters():
            if not p.requires_grad:  # the frozen HuBERT is in no optimizer
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[side][name].numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=name)
            n += 1
        assert n > 10
