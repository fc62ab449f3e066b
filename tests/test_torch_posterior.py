"""The posterior encoder: the port's PosteriorEncoder == JAX's.

A small encoder (spec 33 -> hidden 16, inter 8, 16 WN layers, speaker
conditioning) on shared random weights, with JAX's normal draw injected as
`eps` (threefry cannot be reproduced in PyTorch), and the draw from a
generator checked for shape and masking. float32 on the CPU: z, m, logs
atol 1e-4, rtol 1e-3 (16 chained WN layers).
"""

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.models.posterior import PosteriorEncoder as JaxPosterior
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.posterior import PosteriorEncoder

torch.set_num_threads(1)
SPEC, INTER, HID, GIN = 33, 8, 16, 4


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    x = (np.abs(rng.standard_normal((2, 25, SPEC))) * 0.5).astype(np.float32)
    lens = np.array([25, 17], np.int32)
    g = rng.standard_normal((2, GIN)).astype(np.float32)
    jm = JaxPosterior(SPEC, INTER, HID, 5, 1, 16, gin_channels=GIN)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lens, g=g,
                                            rng=jax.random.PRNGKey(1)))["params"]
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    tm = PosteriorEncoder(SPEC, INTER, HID, 5, 1, 16, gin_channels=GIN)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm, x, lens, g


def test_posterior_matches_jax(models):
    jm, params, tm, x, lens, g = models
    key = jax.random.PRNGKey(5)
    z, m, logs, mask = jax.jit(lambda p: jm.apply({"params": p}, x, lens, g=g, rng=key))(params)
    eps = np.array(jax.random.normal(key, np.asarray(m).shape, np.float32))
    with torch.no_grad():
        tz, tmu, tlogs, tmask = tm(torch.from_numpy(x), torch.from_numpy(lens),
                                   torch.from_numpy(g), eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    for name, a, r in (("m", tmu, m), ("logs", tlogs, logs), ("z", tz, z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3, err_msg=name)
    assert np.abs(np.asarray(z)).mean() > 1e-2


def test_posterior_draws_from_generator(models):
    _, _, tm, x, lens, g = models
    args = (torch.from_numpy(x), torch.from_numpy(lens), torch.from_numpy(g))
    with torch.no_grad():
        z1 = tm(*args, generator=torch.Generator().manual_seed(3))[0]
        z2 = tm(*args, generator=torch.Generator().manual_seed(3))[0]
        z3 = tm(*args, generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(z1, z2) and not torch.equal(z1, z3)
    assert torch.all(z1[1, 17:] == 0)
