"""The GAN train step: the port's TrainStep == JAX's make_train_step.

The tiny configuration of tests/test_train_step.py with p_dropout 0, on
shared random weights (`_draw`, carried across with params_from_jax /
disc_params_from_jax).
JAX's draws are replayed from its key splits (step.py: the step key ->
(sample, dropout), the recompute's fold_in(key, 1); synthesizer.py:
sample -> (posterior, slice); posterior.py: normal eps; masking.py:
uniform starts) and injected into the port. The port's frozen targets go
through K3's plain version (a DFT by matmul), JAX's through its XLA rfft.
float32 on the CPU. Every metric and both grad norms to rtol 1e-4 (atol
1e-6 for values near zero). Gradients are read from Adam's first moment
after the step (mu = (1 - b1) * g on both sides) and held for every
element to rtol 1e-4 and an atol that is a share of the tensor's largest
gradient, set above the largest share measured with these inputs:

* generator (`G_SHARE` 1e-3; measured 2.0e-4, flow.flow_0.enc.in_2.v):
  float32 sums in another order through the couplings and the KL's
  exp(-2 logs_p) (a KL of 9e4, a gradient norm of 1.3e7);
* discriminators, their half of the step run alone on JAX's updated
  generator (`D_SHARE` 1e-5; measured 1.1e-6, mpd.disc_p2.conv_0.v);
* discriminators in the whole step (`D_CHAINED_SHARE` 5e-2; measured
  1.9e-2, mpd.disc_p3.conv_4.bias): their loss runs on the port's updated
  generator, which differs from JAX's where a generator gradient's sign
  is rounding noise (about 160 of 139k elements, each moved by 2 * lr).

Updated parameters, G from the whole step and D from its half on JAX's
generator: rtol 1e-4 wherever the gradient exceeds `SIGN_BAND` (1e-5) of
the tensor's largest. Adam's first step moves a parameter by
lr * g / (|g| + 1e-9), about lr * sign(g); the signs that differ between
the port and JAX all lie below 7.9e-7 of the largest, so only the
elements below the band are held to the step's own bound, 2 * lr. So are
the attention's key biases, whose gradient is zero in exact arithmetic
(softmax ignores a shift of every key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.state import create_train_state
from vcvits_tpu.train.step import init_params, make_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.train.state import is_frozen
from vcvits_tpu_torch.train.step import StepDraws, TrainStep, _Sections

torch.set_num_threads(1)

HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {
    "train": {"segment_size": 2048, "batch_size": 2, "steps_per_epoch": 10,
              "disc_time_fold": False},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 8},
    "model": {
        "inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
        "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0,
        "hubert_channels": 16, "num_pitch": 64, "gin_channels": 4,
        "upsample_initial_channel": 32,
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
        "multi_period_discriminator_periods": [2, 3],
    },
}
RTOL, ATOL = 1e-4, 1e-6
# elementwise gradient atol as a share of the tensor's largest gradient
G_SHARE, D_SHARE, D_CHAINED_SHARE = 1e-3, 1e-5, 5e-2
# share of the largest gradient below which its sign is rounding noise
SIGN_BAND = 1e-5


def _draw(rng, shape):
    """N(0, 1/fan_in) kernels (fan_in: every axis but the last), N(0, 0.2^2)
    vectors: activations stay O(1), so the decoder's tanh is not saturated
    (where it is, its gradient 1 - tanh^2 is all rounding)."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 25
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _batch():
    g = np.random.default_rng(0)
    tx, ty = 5120, 15360  # 0.32 s; ty = 3 * tx (48 kHz), 30 spectrogram frames
    return {
        "x_wav": (g.standard_normal((2, tx)) * 0.1).astype(np.float32),
        "x_wav_lengths": np.array([tx, tx - 640], np.int32),
        "x_pitch": g.integers(1, 64, (2, tx // 320)).astype(np.int32),
        "y_wav": (g.standard_normal((2, ty)) * 0.1).astype(np.float32),
        "y_wav_lengths": np.array([ty, ty - 2048], np.int32),
        "sid": np.array([1, 5], np.int32),
    }


def _jax_draws(key, batch, cfg):
    """The posterior eps and segment starts JAX draws from the step key
    `key`, for the G-step forward and the D-step recompute."""
    b, hop = batch["y_wav"].shape[0], cfg.data.hop_length
    t_spec = batch["y_wav"].shape[1] // hop
    seg = cfg.train.segment_size // hop
    lens = jnp.asarray(batch["y_wav_lengths"]) // hop

    def one(r_sample):
        r_post, r_slice = jax.random.split(r_sample)
        eps = jax.random.normal(r_post, (b, t_spec, cfg.model.inter_channels), jnp.float32)
        u = jax.random.uniform(r_slice, (b,))
        ids = jnp.floor(u * jnp.maximum(lens - seg + 1, 1).astype(u.dtype)).astype(jnp.int32)
        return torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(ids))

    r_sample, _ = jax.random.split(key)
    r_sample2, _ = jax.random.split(jax.random.fold_in(key, 1))
    (eps, ids), (eps2, ids2) = one(r_sample), one(r_sample2)
    return StepDraws(eps=eps, ids_str=ids, eps2=eps2, ids_str2=ids2)


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = JaxConfig.from_dict(CFG), Config.from_dict(CFG)
    hub = JaxHubertConfig(**HUBERT)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_shapes, d_shapes = jax.eval_shape(
        lambda: init_params(jcfg, jax.random.PRNGKey(0), jbatch, hubert_cfg=hub))
    rng = np.random.default_rng(1)
    g_params, d_params = (
        jax.tree.map(lambda s: _draw(rng, s.shape), t)
        for t in (g_shapes, d_shapes))
    state = create_train_state(jcfg, g_params, d_params)
    key = jax.random.PRNGKey(7)
    state1, metrics = jax.jit(make_train_step(jcfg, hubert_cfg=hub))(state, jbatch, key)

    port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT),
                     g_state=params_from_jax(g_params), d_state=disc_params_from_jax(d_params))
    before = {n: p.detach().clone() for n, p in port.gen.named_parameters()}
    before.update({f"disc.{n}": p.detach().clone() for n, p in port.disc.named_parameters()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = _jax_draws(key, batch, jcfg)
    got = port(tbatch, draws)

    # the discriminators' half alone, from the same starting weights, on
    # JAX's updated generator and the recompute's draws
    d_port = TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT),
                       g_state=params_from_jax(state1.g_params),
                       d_state=disc_params_from_jax(d_params))
    d_got = d_port._discriminator_step(tbatch, d_port._features(tbatch), None, None, draws,
                                       _Sections(None, d_port.device))
    return state1, metrics, port, got, before, d_port, {k: v.detach() for k, v in d_got.items()}


def test_one_step_metrics_match_jax(run):
    _, metrics, _, got, _, _, d_got = run
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(got["grad_norm_g"]) > 0 and float(got["grad_norm_d"]) > 0
    for k, v in d_got.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def _zero_in_exact_arithmetic(name):
    """The attention's key biases: softmax ignores a shift of every key."""
    return name.endswith(".conv_k.bias")


def _adam_mu(opt_state):
    """JAX's Adam first moment tree, the frozen (masked) leaves dropped."""
    inner = getattr(opt_state, "inner_state", opt_state)
    mu = next(s for s in inner if hasattr(s, "mu")).mu

    def keep(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = keep(v)
            elif hasattr(v, "shape"):
                out[k] = np.asarray(v)
        return out

    return keep(mu)


def _side(run, side):
    """(port module, its optimizer, JAX's first moment and updated params
    as port-named tensors): G from the whole step, D from its half on JAX's
    updated generator."""
    state1, _, port, _, _, d_port, _ = run
    if side == "g":
        return (port.gen, port.g_opt, params_from_jax(_adam_mu(state1.g_opt_state)),
                params_from_jax(state1.g_params))
    return (d_port.disc, d_port.d_opt, disc_params_from_jax(_adam_mu(state1.d_opt_state)),
            disc_params_from_jax(state1.d_params))


def _assert_mu_close(module, opt, ref, share):
    params = dict(module.named_parameters())
    assert set(ref) == {n for n, p in params.items() if p.requires_grad}
    for name, want in ref.items():
        if _zero_in_exact_arithmetic(name):
            continue
        np.testing.assert_allclose(opt.state[params[name]]["exp_avg"].numpy(), want.numpy(),
                                   rtol=RTOL, atol=share * want.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("side", ["g", "d"])
def test_one_step_gradients_match_jax(run, side):
    module, opt, mu, _ = _side(run, side)
    _assert_mu_close(module, opt, mu, G_SHARE if side == "g" else D_SHARE)


def test_chained_discriminator_gradients_match_jax(run):
    """The whole step's D gradients, on the port's own updated generator."""
    state1, _, port, _, _, _, _ = run
    _assert_mu_close(port.disc, port.d_opt,
                     disc_params_from_jax(_adam_mu(state1.d_opt_state)), D_CHAINED_SHARE)


@pytest.mark.parametrize("side", ["g", "d"])
def test_one_step_updated_params_match_jax(run, side):
    module, _, mu, conv = _side(run, side)
    params = dict(module.named_parameters())
    assert set(conv) == set(params)
    lr = run[2].schedule(0)
    for name, want in conv.items():
        got = params[name].detach()
        if name not in mu:  # frozen: not stepped
            tiny = torch.zeros_like(got, dtype=torch.bool)
        elif _zero_in_exact_arithmetic(name):
            tiny = torch.ones_like(got, dtype=torch.bool)
        else:
            tiny = mu[name].abs() <= SIGN_BAND * mu[name].abs().max().item()
        np.testing.assert_allclose(got[~tiny].numpy(), want[~tiny].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        if tiny.any():
            assert (got[tiny] - want[tiny]).abs().max().item() <= 2 * lr * (1 + RTOL) + ATOL, \
                name


def test_hubert_frozen_and_every_parameter_trained(run):
    _, _, port, _, before, _, _ = run
    named = dict(port.gen.named_parameters())
    named.update({f"disc.{n}": p for n, p in port.disc.named_parameters()})
    frozen = [n for n in named if is_frozen(n)]
    assert frozen and all(torch.equal(named[n], before[n]) for n in frozen)
    for n, p in named.items():
        if n in frozen:
            assert p.grad is None, n
            continue
        assert p.grad is not None and p.grad.abs().sum() > 0, n
        assert not torch.equal(p, before[n]), n


def test_training_decoder_path_trains_every_res_block():
    """fused_mrf=False: the decoder's res blocks get gradients (K1, the
    inference path, has no backward)."""
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    gen = SynthesizerSVC.from_config(Config.from_dict(CFG), device="cpu",
                                     hubert_cfg=HubertConfig(**HUBERT), seed=3)
    z = torch.randn(2, 4, 8)
    gen.dec(z, g=torch.randn(2, 4), fused_mrf=False).square().mean().backward()
    res = [(n, p) for n, p in gen.dec.named_parameters() if ".res_" in f".{n}"]
    assert res and all(p.grad is not None and p.grad.abs().sum() > 0 for _, p in res)
