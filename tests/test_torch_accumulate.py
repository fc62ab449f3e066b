"""Gradient accumulation: the port's TrainStep with accumulate_grad_batches
k = 2 == JAX's make_train_step under optax.MultiSteps, float32 on the CPU.

The tiny configuration, weights and batch of tests/test_torch_train_step.py,
with k = 2 and a schedule that halves the rate every step (steps_per_epoch
1, lr_decay 0.5), so its two counts show: AdamW's rate counts real updates
(lr0, then lr0 / 2) while the logged `learning_rate` counts mini-steps
(lr0, lr0 / 2, lr0 / 4, lr0 / 8). Four mini-steps, each with its own key
and JAX's draws replayed. Metrics, grad norms included (each mini-batch's
own), to rtol 1e-4 (atol 1e-6), as in the one-step test. Parameters: bit-
unchanged on the port after mini-steps 1 and 3; after 2 and 4 held to
JAX's with the sign-band rule of that test, where the band's elements are
held to the moves Adam can make, `2 * (lr_1 + ... + lr_n)` over the n
update. The second update is held from JAX's state after the first
(`train_state_from_jax` after mini-step 2, then mini-steps 3 and 4): on
the port's own first update the elements in that band differ by up to
2 lr_1, and the next gradients ride on that (up to 5e-2 of the largest,
as the whole step's D gradients in the one-step test), which flips the
sign of the second update of other small elements. For the same reason
the discriminators' band is the one-step test's D_CHAINED_SHARE (5e-2)
of the largest: on the k-th mini-step their half runs on the port's own
updated generator (measured: 13 of 2.5M elements of
mpd.disc_p3.conv_3.v outside rtol 1e-4 below that band, by up to 0.056
lr_2). The value clip is checked on the optimizer alone (the
same k = 2 chain, random gradients), where it bites.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (
    CFG, D_CHAINED_SHARE, HUBERT, RTOL, ATOL, SIGN_BAND, _batch, _draw, _jax_draws,
    _zero_in_exact_arithmetic)
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.state import create_train_state, make_optimizer as jax_make_optimizer
from vcvits_tpu.train.step import init_params, make_train_step
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import (
    _arrays_only, disc_params_from_jax, params_from_jax, train_state_from_jax)
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.train.checkpoint import CheckpointManager
from vcvits_tpu_torch.train.state import (
    GradAccumulator, accumulate_and_step, exponential_epoch_schedule, make_optimizer)
from vcvits_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)

K = 2
ACC_CFG = {**CFG, "trainer": {"accumulate_grad_batches": K},
           "train": {**CFG["train"], "steps_per_epoch": 1, "lr_decay": 0.5}}
N_MINI = 4
CLIP = 1e-3


def _port(cfg, g_params, d_params):
    return TrainStep(cfg, device="cpu", hubert_cfg=HubertConfig(**HUBERT),
                     g_state=params_from_jax(g_params), d_state=disc_params_from_jax(d_params))


def _snapshot(port):
    out = {n: p.detach().clone() for n, p in port.gen.named_parameters()}
    out.update({f"disc.{n}": p.detach().clone() for n, p in port.disc.named_parameters()})
    return out


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, cfg = JaxConfig.from_dict(ACC_CFG), Config.from_dict(ACC_CFG)
    hub = JaxHubertConfig(**HUBERT)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    g_shapes, d_shapes = jax.eval_shape(
        lambda: init_params(jcfg, jax.random.PRNGKey(0), jbatch, hubert_cfg=hub))
    rng = np.random.default_rng(1)
    g_params, d_params = (jax.tree.map(lambda s: _draw(rng, s.shape), t)
                          for t in (g_shapes, d_shapes))
    step_fn = jax.jit(make_train_step(jcfg, hubert_cfg=hub))
    keys = [jax.random.PRNGKey(7 + i) for i in range(N_MINI)]
    state = create_train_state(jcfg, g_params, d_params)
    jax_states, jax_metrics = [], []
    for key in keys:
        state, m = step_fn(state, jbatch, key)
        jax_states.append(_numpy(state))
        jax_metrics.append({k: float(v) for k, v in m.items()})

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = [_jax_draws(key, batch, jcfg) for key in keys]
    port = _port(cfg, g_params, d_params)
    snaps, metrics, saved = [_snapshot(port)], [], None
    for i in range(N_MINI):
        metrics.append({k: float(v) for k, v in port(tbatch, draws[i]).items()})
        snaps.append(_snapshot(port))
        if i == 0:
            saved = {"accum": {k: v for k, v in port.state_dict()["accum"].items()
                               if k in ("mini_step", "updates")},
                     "g_mean": {n: m.clone() for n, m in
                                port.state_dict()["accum"]["g"].items()}}
            ckpt = CheckpointManager(str(tmp_path_factory.mktemp("ckpt")))
            ckpt.save(1, port.state_dict())
            ckpt.wait()
    return dict(ckpt=ckpt, cfg=cfg, jcfg=jcfg, g_params=g_params, d_params=d_params, tbatch=tbatch,
                draws=draws, jax_states=jax_states, jax_metrics=jax_metrics, port=port,
                snaps=snaps, metrics=metrics, after1=saved)


def test_metrics_match_jax_every_mini_step(run):
    lr0 = run["cfg"].train.learning_rate
    for i, (got, want) in enumerate(zip(run["metrics"], run["jax_metrics"])):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=f"{i}: {k}")
        # the logged rate counts mini-steps
        np.testing.assert_allclose(got["learning_rate"], lr0 * 0.5 ** i, rtol=1e-6)
        assert got["grad_norm_g"] > 0 and got["grad_norm_d"] > 0


def test_parameters_move_only_on_the_kth_mini_step(run):
    snaps = run["snaps"]
    for i in range(1, N_MINI + 1):
        moved = [n for n in snaps[i] if not torch.equal(snaps[i][n], snaps[i - 1][n])]
        if i % K:
            assert moved == [], (i, moved[:5])
        else:
            assert len(moved) > 0.9 * len(snaps[i]), i


def test_adamw_counts_real_updates(run):
    port = run["port"]
    assert port.step == N_MINI and port.updates == N_MINI // K and port.mini_step == 0
    for opt in (port.g_opt, port.d_opt):
        steps = {float(s["step"]) for s in opt.state.values()}
        assert steps == {float(N_MINI // K)}
    # the updates ran at the rate of their own count: lr0, lr0 / 2
    lr0 = run["cfg"].train.learning_rate
    assert port.g_opt.param_groups[0]["lr"] == pytest.approx(lr0 * 0.5, rel=1e-6)
    assert [int(s.inner_state.gradient_step) for s in
            (js.g_opt_state for js in run["jax_states"])] == [0, 1, 1, 2]


def _mu(opt_state):
    """JAX's Adam first moment under MultiSteps, the frozen leaves dropped."""
    inner = getattr(opt_state, "inner_state", opt_state).inner_opt_state
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


def _assert_params_match(snap, jax_state, lr, band_mus):
    """G and D parameters against JAX's, rtol 1e-4 outside the band of the
    updates' first moments `band_mus`, within 2 * `lr` inside it. The band
    is SIGN_BAND of the largest for G; for D, whose gradients on the k-th
    mini-step ride on the port's own updated generator, D_CHAINED_SHARE."""
    want = dict(params_from_jax(jax_state.g_params))
    want.update({f"disc.{n}": v for n, v in disc_params_from_jax(jax_state.d_params).items()})
    for name, w in want.items():
        got = snap[name]
        tiny = torch.zeros_like(got, dtype=torch.bool)
        if "hubert" not in name.split("."):
            if _zero_in_exact_arithmetic(name):
                tiny |= True
            band = D_CHAINED_SHARE if name.startswith("disc.") else SIGN_BAND
            for mus in band_mus:
                mu = mus[name]
                tiny |= mu.abs() <= band * mu.abs().max().item()
        np.testing.assert_allclose(got[~tiny].numpy(), w[~tiny].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        if tiny.any():
            assert (got[tiny] - w[tiny]).abs().max().item() <= 2 * lr * (1 + RTOL) + ATOL, name


def _mus(jax_state):
    out = dict(params_from_jax(_mu(jax_state.g_opt_state)))
    out.update({f"disc.{n}": v for n, v in
                disc_params_from_jax(_mu(jax_state.d_opt_state)).items()})
    return out


def test_parameters_match_jax_after_the_first_update(run):
    _assert_params_match(run["snaps"][K], run["jax_states"][K - 1],
                         run["cfg"].train.learning_rate, [_mus(run["jax_states"][K - 1])])


def test_parameters_match_jax_after_the_second_update(run):
    """From JAX's state after mini-step 2 (moments and counts carried by
    train_state_from_jax), mini-steps 3 and 4 land JAX's second update at
    lr0 / 2."""
    port = TrainStep(run["cfg"], device="cpu", hubert_cfg=HubertConfig(**HUBERT), seed=3)
    port.load_state_dict(train_state_from_jax(run["jax_states"][K - 1]))
    assert (port.step, port.mini_step, port.updates) == (K, 0, 1)
    for i in (K, K + 1):
        got = port(run["tbatch"], run["draws"][i])
        for k, v in run["jax_metrics"][i].items():
            np.testing.assert_allclose(float(got[k]), v, rtol=RTOL, atol=ATOL, err_msg=k)
    assert port.updates == 2
    _assert_params_match(_snapshot(port), run["jax_states"][2 * K - 1],
                         run["cfg"].train.learning_rate * 0.5, [_mus(run["jax_states"][2 * K - 1])])


def test_running_mean_after_first_mini_step_matches_jax(run):
    """The accumulator after mini-step 1 (the first mini-batch's gradient)
    == optax's acc_grads, to 1e-3 of each tensor's largest (the one-step
    test's G_SHARE)."""
    after1 = run["after1"]
    assert after1["accum"] == {"mini_step": 1, "updates": 0}
    want = params_from_jax(_arrays_only(run["jax_states"][0].g_opt_state.inner_state.acc_grads))
    got = after1["g_mean"]
    assert set(got) == set(want)
    for name, w in want.items():
        if _zero_in_exact_arithmetic(name):
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL,
                                   atol=1e-3 * w.abs().max().item(), err_msg=name)


def test_resume_mid_accumulation_lands_the_same_update(run):
    """A checkpoint after mini-step 1, restored into a fresh TrainStep,
    gives the uninterrupted run's parameters after mini-step 2, exactly."""
    mgr = run["ckpt"]
    assert mgr.latest_step() == 1
    # another seed: everything the update needs must come from the checkpoint
    resumed = TrainStep(run["cfg"], device="cpu", hubert_cfg=HubertConfig(**HUBERT), seed=3)
    state, changed = mgr.restore_tolerant(resumed.state_dict())
    assert not changed
    resumed.load_state_dict(state)
    assert (resumed.step, resumed.mini_step, resumed.updates) == (1, 1, 0)
    resumed(run["tbatch"], run["draws"][1])
    snap = _snapshot(resumed)
    for name, want in run["snaps"][2].items():
        assert torch.equal(snap[name], want), name


def test_train_state_from_jax_carries_the_accumulator(run):
    """JAX's state after mini-step 1 -> the port: the accumulator and the
    (still zero) moments come over, and the port's mini-step 2 from it
    lands JAX's first update."""
    got = train_state_from_jax(run["jax_states"][0])
    assert got["step"] == 1
    assert got["accum"]["mini_step"] == 1 and got["accum"]["updates"] == 0
    g_acc = params_from_jax(_arrays_only(run["jax_states"][0].g_opt_state.inner_state.acc_grads))
    assert set(got["accum"]["g"]) == set(g_acc) and g_acc
    for name, v in g_acc.items():
        assert torch.equal(got["accum"]["g"][name], v), name
    assert set(got["accum"]["d"]) == set(disc_params_from_jax(run["d_params"]))
    assert got["g_opt"] and all(float(m["step"]) == 0 and not m["exp_avg"].any()
                                for m in got["g_opt"].values())
    port = TrainStep(run["cfg"], device="cpu", hubert_cfg=HubertConfig(**HUBERT), seed=3)
    port.load_state_dict(got)
    port(run["tbatch"], run["draws"][1])
    assert port.updates == 1
    _assert_params_match(_snapshot(port), run["jax_states"][1], run["cfg"].train.learning_rate,
                         [_mus(run["jax_states"][1])])


@pytest.fixture(scope="module")
def clip_runs(run):
    """optax.masked(MultiSteps(chain(clip?, adamw), 2)) and the port's
    GradAccumulator, clip and AdamW (`accumulate_and_step`) on the decoder's
    parameters and the same random gradients for 4 mini-steps, without and
    with a value clip -> {clip: (port params, JAX params)}."""
    rng = np.random.default_rng(5)
    start = {"dec": run["g_params"]["dec"]}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
                          start) for _ in range(N_MINI)]
    out = {}
    for clip in (None, CLIP):
        cfg = dataclasses.replace(run["cfg"], train=dataclasses.replace(run["cfg"].train,
                                                                        grad_clip=clip))
        opt = jax_make_optimizer(JaxConfig.from_dict(cfg.to_dict()), freeze_hubert=True)
        update = jax.jit(opt.update)
        params, state = start, opt.init(start)
        named = {n: torch.nn.Parameter(v) for n, v in params_from_jax(start).items()}
        t_opt = make_optimizer(list(named.values()), cfg)
        acc = GradAccumulator(named.values(), K)
        schedule = exponential_epoch_schedule(cfg)
        updates = 0
        for i, g in enumerate(grads):
            upd, state = update(g, state, params)
            params = jax.tree.map(lambda p, u: p + u, params, upd)
            t_opt.param_groups[0]["lr"] = schedule(updates)
            tg = params_from_jax(g)
            for n, p in named.items():
                p.grad = tg[n].clone()
            updates += accumulate_and_step(t_opt, acc, i % K, cfg.train.grad_clip)
        assert updates == N_MINI // K
        out[clip] = ({n: p.detach() for n, p in named.items()},
                     params_from_jax(_numpy(params)))
    return out


@pytest.mark.parametrize("clip", [None, CLIP])
def test_value_clip_on_the_mean_matches_optax(run, clip_runs, clip):
    """The optimizer alone, k = 2, on random N(0, 1e-2) gradients: the
    port == optax to rtol 1e-5; the clip (1e-3, below most of the
    gradients' means) changes the result."""
    got, want = clip_runs[clip]
    start = params_from_jax({"dec": run["g_params"]["dec"]})
    assert set(got) == set(want)
    for n, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-5, atol=1e-7, err_msg=n)
    assert max((got[n] - start[n]).abs().max().item() for n in got) > 0
    if clip is not None:
        unclipped = clip_runs[None][1]
        assert max((want[n] - unclipped[n]).abs().max().item() for n in want) > 1e-6
