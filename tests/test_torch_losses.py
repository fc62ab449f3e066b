"""The GAN losses: the port == JAX on seeded numpy inputs.

feature_loss, discriminator_loss, generator_loss and kl_loss, float32 on
the CPU: rtol 1e-6 on every returned value (sums of a few hundred terms),
and no gradient through the real feature maps.
"""

import jax.numpy as jnp
import numpy as np
import torch

from vcvits_tpu.train import losses as J
from vcvits_tpu_torch.train import losses as P

TOL = dict(rtol=1e-6, atol=1e-7)


def _maps(rng, shapes):
    return [[rng.standard_normal(s).astype(np.float32) for s in head] for head in shapes]


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    shapes = [[(2, 30, 4), (2, 10, 8), (2, 10)], [(2, 7, 3, 1), (2, 21)]]
    fr, fg = _maps(rng, shapes), _maps(rng, shapes)
    t = lambda maps: [[torch.from_numpy(a) for a in h] for h in maps]  # noqa: E731
    j = lambda maps: [[jnp.asarray(a) for a in h] for h in maps]  # noqa: E731
    np.testing.assert_allclose(float(P.feature_loss(t(fr), t(fg))),
                               float(J.feature_loss(j(fr), j(fg))), **TOL)

    dr = [rng.standard_normal((2, n)).astype(np.float32) for n in (30, 7, 12)]
    dg = [rng.standard_normal((2, n)).astype(np.float32) for n in (30, 7, 12)]
    got = P.discriminator_loss([torch.from_numpy(a) for a in dr],
                               [torch.from_numpy(a) for a in dg])
    ref = J.discriminator_loss([jnp.asarray(a) for a in dr], [jnp.asarray(a) for a in dg])
    np.testing.assert_allclose(float(got[0]), float(ref[0]), **TOL)
    for gl, rl in zip(got[1:], ref[1:]):
        np.testing.assert_allclose([float(v) for v in gl], [float(v) for v in rl], **TOL)
    got = P.generator_loss([torch.from_numpy(a) for a in dg])
    ref = J.generator_loss([jnp.asarray(a) for a in dg])
    np.testing.assert_allclose(float(got[0]), float(ref[0]), **TOL)
    np.testing.assert_allclose([float(v) for v in got[1]], [float(v) for v in ref[1]], **TOL)

    z_p, logs_q, m_p, logs_p = (rng.standard_normal((2, 11, 4)).astype(np.float32) * 0.5
                                for _ in range(4))
    mask = (np.arange(11)[None, :] < np.array([11, 6])[:, None]).astype(np.float32)[..., None]
    args = (z_p, logs_q, m_p, logs_p, mask)
    np.testing.assert_allclose(float(P.kl_loss(*(torch.from_numpy(a) for a in args))),
                               float(J.kl_loss(*(jnp.asarray(a) for a in args))), **TOL)


def test_feature_loss_stops_gradient_at_real_maps():
    r = torch.randn(2, 5, requires_grad=True)
    g = torch.randn(2, 5, requires_grad=True)
    P.feature_loss([[r]], [[g]]).backward()
    assert r.grad is None and g.grad is not None
