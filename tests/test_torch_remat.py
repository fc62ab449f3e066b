"""Remat policies on the VC train step (`cfg.train.remat_policy`).

* World 1, the dry run's tiny config with dropout on (p_dropout 0.1, one
  MPD period) and the step's own generators (no injected draws): a
  "dots" and a "nothing" step equal the "none" step from the same seed
  bit for bit, in float32 on the CPU: every metric, gradient and updated
  parameter, AdamW's moments, and both generators' states after the step.
  Each step also draws from the step's generator between the G forward
  and its backward: the recompute must keep that draw, not rewind it, or
  the D half's draws and the generator's end state differ. Each
  recomputes the generator's training forward once in the backward: the
  WaveNet gates (kernel K5 on the card) run 1.5 times as often.
* The same step with a wrap that does not replay the generators (plain
  `torch.utils.checkpoint`, whose preserve_rng_state restores only the
  default generators) differs from "none": the test sees the trap.
* The port's "dots" step against JAX's is in test_torch_remat_jax.py (a
  file of its own: compiling JAX's remat step takes most of a minute).
* An unknown policy raises ValueError naming remat_policy, as JAX's does;
  the TTS step trains with the field set, wraps nothing and computes what
  it computes without it, as JAX's never reads it.
"""

import copy

import pytest
import torch

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.models import wavenet
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.parallel.dryrun import TINY_HUBERT, tiny_batch, tiny_config
from vcvits_tpu_torch.train import step as step_mod
from vcvits_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)


def _cfg(policy: str, base=None) -> Config:
    """`base` (the dry run's tiny config by default) with `policy` set."""
    raw = copy.deepcopy(base or dict(tiny_config(2), model=dict(
        tiny_config(2)["model"], multi_period_discriminator_periods=[2])))
    raw["train"]["remat_policy"] = policy
    return Config.from_dict(raw)


def _after_step(policy: str) -> dict:
    """One step of the tiny config (dropout 0.1) from seed 0 with the
    step's own draws, and one draw of its own from the step's generator
    between the G forward and its backward (where the KL is taken) -> what
    the step leaves: metrics, gradients, updated parameters, AdamW's
    moments, the generators' states, that draw, the gate calls."""
    assert tiny_config(2)["model"]["p_dropout"] > 0
    step = TrainStep(_cfg(policy), device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT), seed=0)
    batch = {k: torch.as_tensor(v) for k, v in tiny_batch(2).items()}
    gate, kl = wavenet.fused_gate, step_mod.kl_loss
    calls, between = [], []

    def counted(*args, **kw):
        calls.append(1)
        return gate(*args, **kw)

    def kl_then_draw(*args, **kw):
        between.append(torch.rand(4, generator=step.generator))
        return kl(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wavenet, "fused_gate", counted)
        mp.setattr(step_mod, "kl_loss", kl_then_draw)
        metrics = step(batch)
    named = [(f"gen.{n}", p) for n, p in step.gen.named_parameters()]
    named += [(f"disc.{n}", p) for n, p in step.disc.named_parameters()]
    moments = {}
    for opt in (step.g_opt, step.d_opt):
        for p, state in opt.state.items():
            moments.update({(id(p), k): v.clone() for k, v in state.items() if k != "step"})
    ids = {id(p): n for n, p in named}
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in named if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in named},
            "moments": {(ids[i], k): v for (i, k), v in moments.items()},
            "generators": (step.generator.get_state(), step.dropout_generator.get_state()),
            "between": between, "gate_calls": len(calls)}


@pytest.fixture(scope="module")
def none_step():
    return _after_step("none")


def _differences(got: dict, want: dict) -> list:
    """Names of what differs between two `_after_step` records."""
    out = []
    for part in ("metrics", "grads", "params", "moments"):
        assert got[part].keys() == want[part].keys(), part
        out += [f"{part}:{k}" for k, v in want[part].items() if not torch.equal(got[part][k], v)]
    out += [f"generator {i}" for i, (a, b) in enumerate(zip(got["generators"],
                                                            want["generators"]))
            if not torch.equal(a, b)]
    if not (len(got["between"]) == len(want["between"]) == 1
            and torch.equal(got["between"][0], want["between"][0])):
        out.append("draw between the forward and the backward")
    return out


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_step_equals_none_bit_for_bit(none_step, policy):
    got = _after_step(policy)
    assert _differences(got, none_step) == []
    assert got["grads"] and got["moments"]
    # the generator forward's gates run again in the backward: the G-step
    # forward, the D half's recompute, and the remat recompute
    assert got["gate_calls"] == none_step["gate_calls"] * 3 // 2 > 0


def test_remat_without_replayed_draws_differs(none_step, monkeypatch):
    """A wrap whose recompute draws afresh (eps, segment starts, dropout
    masks) gives other gradients with no error, and leaves the generators
    elsewhere: the bit-for-bit test above can see that fault."""
    monkeypatch.setattr(step_mod, "checkpointed", lambda fn, policy, generators=(): (
        torch.utils.checkpoint.checkpoint(fn, use_reentrant=False)))
    diff = _differences(_after_step("nothing"), none_step)
    assert any(d.startswith("grads:gen.") for d in diff)
    assert "generator 0" in diff and "generator 1" in diff


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_checkpointed_keeps_draws_made_before_the_backward(policy):
    """`checkpointed` alone: a forward that draws noise and a dropout mask
    from explicit generators, one draw from each between the forward and
    the backward, one after. Wrapped or not, the output, the gradients and
    every draw are the same: the recompute replays the forward's draws and
    then leaves each generator where the backward found it."""

    def run(wrap):
        gens = [torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)]
        w = torch.linspace(-1, 1, 48).reshape(6, 8).requires_grad_(True)
        x = torch.randn(5, 6, generator=torch.Generator().manual_seed(3))

        def fn():
            h = torch.tanh(x @ w + torch.randn(5, 8, generator=gens[0]))
            keep = torch.rand(5, 8, generator=gens[1]) > 0.3
            return (h * keep).sum(1)

        out = step_mod.checkpointed(fn, policy, gens) if wrap else fn()
        draws = [torch.rand(3, generator=g) for g in gens]
        out.pow(2).sum().backward()
        draws += [torch.rand(3, generator=g) for g in gens]
        return out.detach(), w.grad, draws

    (out, grad, draws), (out0, grad0, draws0) = run(True), run(False)
    assert torch.equal(out, out0) and torch.equal(grad, grad0)
    assert all(torch.equal(a, b) for a, b in zip(draws, draws0))


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        TrainStep(_cfg("bogus"), device="cpu", hubert_cfg=HubertConfig(**TINY_HUBERT))


def test_tts_step_ignores_remat_policy(monkeypatch):
    """JAX's TTS step never reads remat_policy; the port's trains with it
    set, wraps nothing in a checkpoint, and computes what it computes
    without it."""
    from tests.test_torch_tts_train import CFG, N_VOCAB, tts_batch
    from vcvits_tpu_torch.data.loader import to_device
    from vcvits_tpu_torch.train.tts_step import TTSTrainStep

    def refuse(*args, **kw):
        raise AssertionError("the TTS step checkpointed a forward")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    monkeypatch.setattr(step_mod, "checkpoint", refuse)
    batch = to_device(tts_batch(), "cpu")
    out = {}
    for policy in ("none", "dots"):
        step = TTSTrainStep(_cfg(policy, CFG), device="cpu", seed=0, n_vocab=N_VOCAB)
        out[policy] = step(batch)
    assert out["dots"].keys() == out["none"].keys()
    for k, v in out["none"].items():
        assert torch.isfinite(v).all() and torch.equal(out["dots"][k], v), k
