"""The WaveNet gate (K5's plain version, and the WN around it) == JAX.

Seeded numpy inputs through JAX's fused_add_tanh_sigmoid_multiply and the
port's `fused_gate` wrapper (its plain version on a CPU tensor), with the
speaker term broadcast over time or absent, as the WaveNet stacks pass
it; any other shape of it is refused. float32 on the CPU:
forward 1e-6 abs; gradients against jax.grad of the same scalar 1e-6 abs
(grad_b, a sum over time, 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.ops.fused_gate import fused_add_tanh_sigmoid_multiply as jax_gate
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.fused_gate import fused_gate

torch.set_num_threads(1)


def _inputs(kind, b=3, t=21, h=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, t, 2 * h)).astype(np.float32)
    shape = {"broadcast": (b, 1, 2 * h), "full": (b, t, 2 * h), "none": None}[kind]
    bb = None if shape is None else rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((b, t, h)).astype(np.float32)
    return a, bb, w


@pytest.mark.parametrize("kind", ["broadcast", "none"])
def test_forward_matches_jax(kind):
    a, b, _ = _inputs(kind)
    h = a.shape[-1] // 2
    ref = jax_gate(jnp.asarray(a), jnp.zeros_like(a) if b is None else jnp.asarray(b), h)
    _build.LAUNCHES.clear()
    got = fused_gate(torch.from_numpy(a), None if b is None else torch.from_numpy(b), h)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["broadcast", "none"])
def test_gradient_matches_jax(kind):
    a, b, w = _inputs(kind, seed=1)
    h = a.shape[-1] // 2
    jb = jnp.zeros((a.shape[0], 1, a.shape[2]), jnp.float32) if b is None else jnp.asarray(b)

    def loss(a, b):
        return jnp.sum(jax_gate(a, b, h) * w)

    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jb)
    ta = torch.from_numpy(a).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    (fused_gate(ta, tb, h) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=1e-6, rtol=0)
    if tb is not None:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=1e-5, rtol=0)


def test_refuses_a_speaker_term_per_frame():
    a, b, _ = _inputs("full")
    with pytest.raises(ValueError, match=r"\[B, 1, 2H\] or None"):
        fused_gate(torch.from_numpy(a), torch.from_numpy(b), a.shape[-1] // 2)
