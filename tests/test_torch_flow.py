"""PyTorch WaveNet, coupling flow and ops/flow_coupling.py == JAX.

Every weight is random and non-zero, `post` included: JAX initialises
`post` to zero, which makes a fresh coupling reverse nearly an identity and
would check little of the coupling arithmetic. Ragged batches carry per-row
masks and per-row speaker vectors. The plain version of kernel K2 is held
against the Pallas kernel run with interpret=True and against the flax
module path. float32 on the CPU: atol 2e-5 / rtol 1e-4 for one coupling,
atol 1e-4 / rtol 1e-3 through four.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.models.flow import ResidualCouplingBlock as JaxBlock
from vcvits_tpu.models.wavenet import WN as JaxWN
from vcvits_tpu.ops.flow_pallas import _coupling_reverse, _coupling_weights, flow_reverse_fused
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.flow import ResidualCouplingBlock
from vcvits_tpu_torch.models.wavenet import WN
from vcvits_tpu_torch.ops.flow_coupling import coupling_reverse_plain

torch.set_num_threads(1)
CH, HID, GIN = 8, 16, 4
TOL4 = dict(atol=1e-4, rtol=1e-3)


def _random_params(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                        shapes)


def _inputs(batch, t, gin, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, t, CH)).astype(np.float32)
    lens = np.array([t - 5 * i for i in range(batch)])
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    g = rng.standard_normal((batch, gin)).astype(np.float32) if gin else None
    return x, mask, g


@pytest.fixture(scope="module", params=[GIN, 0], ids=["speaker", "no_speaker"])
def block(request):
    gin = request.param
    x, mask, g = _inputs(3, 40, gin, seed=gin)
    jm = JaxBlock(CH, HID, 5, 1, 4, gin_channels=gin)
    p = _random_params(jm, x, mask, g=g, seed=1 + gin)
    tm = ResidualCouplingBlock(CH, HID, 5, 1, 4, gin_channels=gin)
    tm.load_state_dict(params_from_jax(p))
    return jm, p, tm, x, mask, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_wavenet():
    x, mask, g = _inputs(2, 30, GIN, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 30, HID)).astype(np.float32)
    jm = JaxWN(HID, 5, 1, 4, gin_channels=GIN)
    p = _random_params(jm, x, mask, g=g)
    ref = jax.jit(lambda p, x, m, g: jm.apply({"params": p}, x, m, g=g))(p, x, mask, g)
    tm = WN(HID, 5, 1, 4, gin_channels=GIN)
    tm.load_state_dict(params_from_jax(p))
    got = tm(_t(x), _t(mask), _t(g)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL4)


@pytest.mark.parametrize("reverse", [False, True])
def test_block_module_path(block, reverse):
    jm, p, tm, x, mask, g = block
    ref = jax.jit(lambda p, x, m, g: jm.apply({"params": p}, x, m, g=g, reverse=reverse))(
        p, x, mask, g)
    got = tm(_t(x), _t(mask), _t(g), reverse=reverse).detach().numpy()
    np.testing.assert_allclose(got * mask, np.asarray(ref) * mask, **TOL4)


def test_kernel_reverse_matches_pallas_interpret(block):
    """The inference reverse (ops/flow_coupling.py's plain version on the
    CPU) against flow_reverse_fused(interpret=True) and against the flax
    module path, all four couplings."""
    jm, p, tm, x, mask, g = block
    ref = flow_reverse_fused(p, jnp.asarray(x), jnp.asarray(mask),
                             g=None if g is None else jnp.asarray(g), tile=16, interpret=True)
    with torch.no_grad():
        got = tm.kernel_reverse(_t(x), _t(mask), _t(g)).numpy()
    np.testing.assert_allclose(got * mask, np.asarray(ref) * mask, **TOL4)
    module_path = jm.apply({"params": p}, x, mask, g=g, reverse=True)
    np.testing.assert_allclose(got * mask, np.asarray(module_path) * mask, **TOL4)


def test_folded_weights_follow_the_parameters(block):
    """The reverse folds its weights once and refolds after load_state_dict,
    an in-place edit or a conversion, never giving a stale answer."""
    _, p, _, x, mask, g = block
    tm = ResidualCouplingBlock(CH, HID, 5, 1, 4, gin_channels=0 if g is None else GIN)
    tm.load_state_dict(params_from_jax(p))

    def run(m):
        with torch.no_grad():
            return m(_t(x), _t(mask), _t(g), reverse=True)

    def fresh():  # an unused copy of tm's current parameters
        m = ResidualCouplingBlock(CH, HID, 5, 1, 4, gin_channels=0 if g is None else GIN)
        m.load_state_dict(tm.state_dict())
        return run(m)

    first = run(tm)
    assert len(tm.folded(lambda: pytest.fail("the folded weights were rebuilt"))) == 4
    tm.load_state_dict({k: v * 1.1 for k, v in tm.state_dict().items()})
    after_load = run(tm)
    assert not torch.equal(after_load, first)
    torch.testing.assert_close(after_load, fresh(), atol=0, rtol=0)
    with torch.no_grad():
        tm.flow_1.post.bias.add_(0.5)
    torch.testing.assert_close(run(tm), fresh(), atol=0, rtol=0)
    tm.double().float()
    torch.testing.assert_close(run(tm), fresh(), atol=0, rtol=0)


@pytest.mark.parametrize("tile", [8, 24])
def test_one_coupling_matches_pallas_kernel(block, tile):
    """One coupling: the plain version of K2 against the Pallas kernel body
    in interpret mode, on the same folded weights and conditioning."""
    jm, p, tm, x, mask, g = block
    layer = tm.flow_2
    weights = layer.kernel_weights()
    jax_w = _coupling_weights(p["flow_2"], HID, CH // 2)
    # the port folds into the Pallas kernel's layout (biases unsqueezed there)
    for mine, theirs in zip(weights, jax_w):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs).reshape(mine.shape),
                                   atol=1e-6, rtol=1e-5)
    with torch.no_grad():
        cond = layer.enc.cond_vector(_t(g))
    jcond = (np.zeros((x.shape[0], 1, 8 * HID), np.float32) if cond is None
             else cond.numpy()[:, None, :])
    ref = _coupling_reverse(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(jcond), jax_w,
                            HID, CH // 2, tile, True)
    got = coupling_reverse_plain(_t(x), _t(mask), cond, weights).numpy()
    np.testing.assert_allclose(got * mask, np.asarray(ref) * mask, atol=2e-5, rtol=1e-4)
