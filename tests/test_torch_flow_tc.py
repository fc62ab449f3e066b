"""The host side of K2's tensor-core kernel (csrc/flow_coupling.cu), on the CPU.

* A PyTorch model of the kernel's schedule: 80-row tiles (64 centre frames
  and a halo of 8 at K = 5, L = 4), rows outside [0, T) zero through the
  mask, a conv margin of zeros, and each CTA of the cluster computing only
  its slice of channels (pre's h, the gate's tanh/sigmoid pairs, res_skip's
  res and skip halves, every n-th row of post), the slices exchanged in the
  kernel's order (h, then per layer the gate and the new h, then the skip).
  In all three modes it equals the plain version within 1e-6 of the
  output's largest value (a few float32 ulps) for T below a tile, T = 64k
  +- 1 and a ragged batch; without the zeroing outside [0, T) pre's bias
  leaks into the conv and it does not (error > 1e-2).
* A NumPy model of 3xTF32 as the kernel does it (a fresh fp32 partial sum
  per 32-channel slice of a weight tile) on one layer's conv, depth
  K * H = 640, against float64: within 1e-5 x RMS, where one TF32 product
  per multiply-add is above 1e-4.
* `plan` fits the flow and the posterior of configs/48k_base.json and
  configs/base.json in 227 KB and refuses the sizes the kernel does not take.
* The plain forward mode through `ResidualCouplingBlock.kernel_forward`
  against the flax module path's forward, and the plain WaveNet mode chained
  over 16 layers (`WN.kernel_forward`, `PosteriorEncoder(fused_wn=True)`)
  against JAX's WN and posterior, with random non-zero weights, ragged
  masks, and a speaker or none. float32: atol 1e-4 / rtol 1e-3 through four
  couplings or 16 layers, as tests/test_torch_flow.py holds the reverse.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.models.flow import ResidualCouplingBlock as JaxBlock
from vcvits_tpu.models.posterior import PosteriorEncoder as JaxPosterior
from vcvits_tpu.models.wavenet import WN as JaxWN
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.flow import ResidualCouplingBlock
from vcvits_tpu_torch.models.posterior import PosteriorEncoder
from vcvits_tpu_torch.models.wavenet import WN
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.flow_coupling import (
    FORWARD, MAX_SMEM, REVERSE, ROWS, WN_SEGMENT, WN_SEGMENT_LAYERS, coupling_forward,
    coupling_forward_plain, coupling_reverse_plain, plan, wn_segment, wn_segment_plain)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL4 = dict(atol=1e-4, rtol=1e-3)


def _weights(rng, half, hidden, n_layers, k):
    """Random folded coupling weights, the last res_skip packed (res half 0),
    pre's bias 0.5 (large enough to leak visibly if rows outside [0, T) are
    not zeroed)."""
    def rand(shape, scale):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32)
    ws = [rand((half, hidden), 1 / np.sqrt(half)), torch.full((hidden,), 0.5),
          rand((n_layers, k, hidden, 2 * hidden), 1 / np.sqrt(k * hidden)),
          rand((n_layers, 2 * hidden), 0.1), rand((n_layers, hidden, 2 * hidden),
                                                  1 / np.sqrt(hidden)),
          rand((n_layers, 2 * hidden), 0.1), rand((hidden, half), 1 / np.sqrt(hidden)),
          rand((half,), 0.1)]
    ws[4][-1, :, :hidden] = 0
    ws[5][-1, :hidden] = 0
    return tuple(ws)


def _tiled(mode, x, mask, cond, weights, skip_in=None, zero_outside=True):
    """The kernel's schedule in PyTorch: per tile and per CTA slice. x is
    [B, T, 2 half] (couplings) or h_in [B, T, H] (WN_SEGMENT, `weights` the
    middle four and `skip_in` [B, T, H])."""
    coupling = mode != WN_SEGMENT
    if coupling:
        w_pre, b_pre, w_in, b_in, w_rs, b_rs, w_post, b_post = weights
    else:
        w_in, b_in, w_rs, b_rs = weights
    n_layers, k, hidden = w_in.shape[:3]
    half = x.shape[2] // 2 if coupling else None
    p = plan(hidden, k, n_layers, half)
    n, pw, kpad = p.cluster, p.pairs, (k - 1) // 2
    assert p.tile + 2 * p.halo == ROWS and p.halo == n_layers * kpad
    sl = [slice(q * pw, (q + 1) * pw) for q in range(n)]          # a CTA's hidden channels
    sl2 = [slice(hidden + q * pw, hidden + (q + 1) * pw) for q in range(n)]  # their partners
    bsz, t_len, _ = x.shape
    out = torch.zeros_like(x)
    skip_out = torch.zeros_like(x) if not coupling else None
    for bi in range(bsz):
        for t0 in range(0, t_len, p.tile):
            times = torch.arange(ROWS) + t0 - p.halo
            inside = (times >= 0) & (times < t_len)
            ms = torch.full((ROWS,), 0.0 if zero_outside else 1.0)
            ms[inside] = mask[bi, times[inside], 0]
            ms = ms[:, None]
            staged = torch.zeros(ROWS, x.shape[2])
            staged[inside] = x[bi, times[inside]]
            skips = [torch.zeros(ROWS, pw) for _ in range(n)]
            if coupling:  # pre: each CTA its h columns, then the exchange
                h = torch.cat([(staged[:, :half] @ w_pre[:, s] + b_pre[s]) * ms for s in sl], 1)
            else:
                h = staged
                sk = torch.zeros(ROWS, hidden)
                sk[inside] = skip_in[bi, times[inside]]
                skips = [sk[:, s].clone() for s in sl]
            for layer in range(n_layers):
                hp = torch.cat([torch.zeros(kpad, hidden), h, torch.zeros(kpad, hidden)])
                cl = (b_in[layer] if cond is None else
                      b_in[layer] + cond[bi, layer * 2 * hidden:(layer + 1) * 2 * hidden])
                gates = []
                for s, s2 in zip(sl, sl2):  # each CTA: its tanh and sigmoid columns
                    acc_t = sum(hp[m:m + ROWS] @ w_in[layer, m][:, s] for m in range(k)) + cl[s]
                    acc_s = sum(hp[m:m + ROWS] @ w_in[layer, m][:, s2] for m in range(k)) + cl[s2]
                    gates.append(torch.tanh(acc_t) * torch.sigmoid(acc_s))
                g = torch.cat(gates, 1)  # exchange: every CTA's full gate copy
                new_h = []
                for q, (s, s2) in enumerate(zip(sl, sl2)):  # each CTA: its res and skip columns
                    new_h.append((h[:, s] + g @ w_rs[layer][:, s] + b_rs[layer][s]) * ms)
                    skips[q] = skips[q] + g @ w_rs[layer][:, s2] + b_rs[layer][s2]
                h = torch.cat(new_h, 1)  # exchange: every CTA's full h copy
            centre = torch.arange(p.halo, p.halo + p.tile)
            keep = centre[times[centre] < t_len]
            if not coupling:
                out[bi, times[keep]] = h[keep]
                skip_out[bi, times[keep]] = torch.cat(skips, 1)[keep]
                continue
            skipm = torch.cat(skips, 1) * ms  # exchange of skip * mask
            for q in range(n):  # each CTA: centre rows q, q + n, ...
                rows = keep[(keep - p.halo) % n == q]
                m = skipm[rows] @ w_post + b_post
                x1, mr = staged[rows, half:], ms[rows]
                x1 = (x1 - m * mr) * mr if mode == REVERSE else (m * mr + x1) * mr
                out[bi, times[rows]] = torch.cat([staged[rows, :half], x1], 1)
    return out if coupling else (out, skip_out)


def _case(t, batch, hidden=64, half=16, seed=0):
    rng = np.random.default_rng(seed + t)
    x = torch.tensor(rng.standard_normal((batch, t, 2 * half)), dtype=torch.float32)
    lens = torch.tensor([t - 9 * i for i in range(batch)])
    mask = (torch.arange(t)[None, :] < lens[:, None]).float()[..., None]
    cond = torch.tensor(rng.standard_normal((batch, 4 * 2 * hidden)) * 0.3, dtype=torch.float32)
    return x, mask, cond, _weights(rng, half, hidden, 4, 5)


CASES = [(37, 1, 64), (127, 1, 64), (129, 2, 64), (150, 3, 64), (129, 1, 128), (65, 1, 256)]


@pytest.mark.parametrize("mode", [REVERSE, FORWARD])
@pytest.mark.parametrize("t,batch,hidden", CASES)
def test_tile_model_couplings_equal_plain(mode, t, batch, hidden):
    """T 37 is below one 64-frame tile; 127 / 129 are 64k -+ 1; the batches
    of 2 and 3 are ragged (lengths t, t - 9, t - 18); 128 and 256 wide run
    clusters of 8 with 16 and 32 channels a CTA."""
    x, mask, cond, w = _case(t, batch, hidden, half=hidden // 4)
    plain = coupling_reverse_plain if mode == REVERSE else coupling_forward_plain
    with torch.no_grad():
        got = _tiled(mode, x, mask, cond, w)
        ref = plain(x, mask, cond, w)
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.parametrize("t,batch,hidden", CASES[:4])
def test_tile_model_wn_segment_equals_plain(t, batch, hidden):
    x, mask, cond, w = _case(t, batch, hidden)
    rng = np.random.default_rng(t)
    h = torch.tensor(rng.standard_normal((batch, t, hidden)), dtype=torch.float32) * mask
    skip = torch.tensor(rng.standard_normal((batch, t, hidden)), dtype=torch.float32)
    with torch.no_grad():
        got_h, got_s = _tiled(WN_SEGMENT, h, mask, cond, w[2:6], skip_in=skip)
        ref_h, ref_s = wn_segment_plain(h, skip, mask, cond, w[2:6])
    for got, ref in ((got_h, ref_h), (got_s, ref_s)):
        assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


def test_tile_model_needs_rows_outside_zeroed():
    """With the mask taken as 1 outside [0, T) (rows staged but not zeroed),
    pre's bias reaches the conv through the halo and the tiles no longer
    equal the plain version: the zeroing is what the tests above hold."""
    x, mask, cond, w = _case(100, 1)
    ref = coupling_reverse_plain(x, mask, cond, w)
    leaked = _tiled(REVERSE, x, mask, cond, w, zero_outside=False)
    assert (leaked - ref).abs().max().item() > 1e-2
    assert (_tiled(REVERSE, x, mask, cond, w) - ref).abs().max().item() \
        <= 1e-6 * ref.abs().max().item()


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: float32 to a 10-bit mantissa, nearest, ties away."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_cut(x: np.ndarray) -> np.ndarray:
    """What the tensor cores read of a float32 operand: its low 13 bits dropped."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_model_meets_1e5_where_tf32_does_not():
    """One layer's conv at the 48k flow's width: 80 rows, K 5, H 128 (depth
    640), the 2H = 256 gate columns; each warp's 32-channel share of a
    weight tile summed into a fresh fp32 partial, the partials added in fp32."""
    rng = np.random.default_rng(0)
    rows, k, h = 80, 5, 128
    x = rng.standard_normal((rows + k - 1, h)).astype(np.float32)
    w = (rng.standard_normal((k, h, 2 * h)) / np.sqrt(k * h)).astype(np.float32)
    exact = sum(x[m:m + rows].astype(np.float64) @ w[m].astype(np.float64) for m in range(k))
    rms = np.sqrt(np.mean(exact ** 2))
    x_hi = _tf32_rna(x)
    x_lo = _tf32_cut(x - x_hi)
    w_hi = _tf32_rna(w)
    w_lo = _tf32_rna(w - w_hi)
    three = np.zeros((rows, 2 * h), np.float32)
    one = np.zeros((rows, 2 * h), np.float32)
    for m in range(k):
        for c in range(0, h, 32):
            a = slice(m, m + rows)
            ch = slice(c, c + 32)
            part = (x_lo[a, ch] @ w_hi[m, ch] + x_hi[a, ch] @ w_lo[m, ch]
                    + x_hi[a, ch] @ w_hi[m, ch])
            three = three + part.astype(np.float32)
            one = one + (x_hi[a, ch] @ w_hi[m, ch]).astype(np.float32)
    err3 = np.abs(three - exact).max() / rms
    err1 = np.abs(one - exact).max() / rms
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1


def _model(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("config", ["configs/48k_base.json", "configs/base.json"])
def test_plan_fits_the_configs(config):
    m = _model(config)
    hidden, half = m["hidden_channels"], m["inter_channels"] // 2
    for p in (plan(hidden, 5, 4, half), plan(hidden, 5, WN_SEGMENT_LAYERS)):
        assert p.smem <= MAX_SMEM and p.tile == 64 and p.halo == 8
        assert p.cluster * p.pairs == hidden and p.cluster <= 8
    assert plan(hidden, 5, 4, half).smem == plan(hidden, 5, 4).smem


@pytest.mark.parametrize("hidden,k,layers,half", [(96, 5, 4, 48), (320, 5, 4, 64), (32, 5, 4, 16),
                                                  (128, 4, 4, 64), (128, 5, 17, None),
                                                  (128, 5, 4, 6), (128, 5, 4, 256)])
def test_plan_refuses(hidden, k, layers, half):
    with pytest.raises(ValueError):
        plan(hidden, k, layers, half)


def _random_params(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                        shapes)


def _ragged(batch, t, ch, gin, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, t, ch)).astype(np.float32)
    lens = np.array([t - 5 * i for i in range(batch)])
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    g = rng.standard_normal((batch, gin)).astype(np.float32) if gin else None
    return x, mask, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("gin", [4, 0], ids=["speaker", "no_speaker"])
def test_kernel_forward_matches_jax_module_path(gin):
    """Four couplings and flips in forward order through the forward mode's
    plain version (random non-zero `post`), against JaxBlock.apply(reverse=False)."""
    ch, hid = 8, 16
    x, mask, g = _ragged(3, 40, ch, gin, seed=gin)
    jm = JaxBlock(ch, hid, 5, 1, 4, gin_channels=gin)
    p = _random_params(jm, x, mask, g=g, seed=1 + gin)
    tm = ResidualCouplingBlock(ch, hid, 5, 1, 4, gin_channels=gin)
    tm.load_state_dict(params_from_jax(p))
    ref = jax.jit(lambda p, x, m, g: jm.apply({"params": p}, x, m, g=g, reverse=False))(
        p, x, mask, g)
    _build.LAUNCHES.clear()
    with torch.no_grad():
        got = tm.kernel_forward(_t(x), _t(mask), _t(g)).numpy()
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors take the plain version
    np.testing.assert_allclose(got * mask, np.asarray(ref) * mask, **TOL4)
    with torch.no_grad():  # and the module path it stands in for
        module = tm(_t(x), _t(mask), _t(g)).numpy()
    np.testing.assert_allclose(got * mask, module * mask, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("gin", [4, 0], ids=["speaker", "no_speaker"])
def test_wn_kernel_forward_matches_jax_wn(gin):
    """16 layers as four chained wn_segment calls (plain on the CPU)."""
    hid = 16
    _, mask, g = _ragged(2, 33, hid, gin, seed=7)
    x = np.random.default_rng(8).standard_normal((2, 33, hid)).astype(np.float32) * mask
    jm = JaxWN(hid, 5, 1, 16, gin_channels=gin)
    p = _random_params(jm, x, mask, g=g, seed=9)
    ref = jax.jit(lambda p, x, m, g: jm.apply({"params": p}, x, m, g=g))(p, x, mask, g)
    tm = WN(hid, 5, 1, 16, gin_channels=gin)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm.kernel_forward(_t(x), _t(mask), _t(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL4)


def test_posterior_fused_wn_matches_jax():
    spec, inter, hid, gin = 33, 8, 16, 4
    rng = np.random.default_rng(0)
    x = (np.abs(rng.standard_normal((2, 25, spec))) * 0.5).astype(np.float32)
    lens = np.array([25, 17], np.int32)
    g = rng.standard_normal((2, gin)).astype(np.float32)
    jm = JaxPosterior(spec, inter, hid, 5, 1, 16, gin_channels=gin)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lens, g=g,
                                            rng=jax.random.PRNGKey(1)))["params"]
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    tm = PosteriorEncoder(spec, inter, hid, 5, 1, 16, gin_channels=gin)
    tm.load_state_dict(params_from_jax(params))
    key = jax.random.PRNGKey(5)
    z, m, logs, mask = jax.jit(lambda p: jm.apply({"params": p}, x, lens, g=g, rng=key))(params)
    eps = np.array(jax.random.normal(key, np.asarray(m).shape, np.float32))
    with torch.no_grad():
        tz, tmu, tlogs, tmask = tm(_t(x), _t(lens), _t(g), eps=_t(eps), fused_wn=True)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    for name, a, r in (("m", tmu, m), ("logs", tlogs, logs), ("z", tz, z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3, err_msg=name)
    assert np.abs(np.asarray(z)).mean() > 1e-2


def test_cpu_wrappers_take_the_plain_versions():
    x, mask, cond, w = _case(40, 2)
    _build.LAUNCHES.clear()
    torch.testing.assert_close(coupling_forward(x, mask, cond, w),
                               coupling_forward_plain(x, mask, cond, w), atol=0, rtol=0)
    h = torch.randn(2, 40, 64)
    got = wn_segment(h, torch.zeros_like(h), mask, cond, w[2:6])
    ref = wn_segment_plain(h, torch.zeros_like(h), mask, cond, w[2:6])
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=0, rtol=0)
    assert sum(_build.LAUNCHES.values()) == 0
