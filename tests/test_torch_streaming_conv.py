"""The port's cached-state streaming flow reverse + decoder
(vcvits_tpu_torch/streaming_conv.py): streamed == offline, port == JAX.

A small flow (8 channels, hidden 16, speaker width 4) and decoder (two
ResBlock1 blocks, upsampling 4 x 2 at width 32) on shared random weights
from numpy, carried over with params_from_jax. At chunk 16 frames the
streamed output, after dropping `delay_samples`, equals the port's own
offline flow reverse + decoder (the plain versions of K2 and K1 on the CPU)
and JAX's StreamingFlowDecoder on the same weights and z_p, float32, atol
1e-5 (1e-4 relative). The transposed conv as zero-stuffing + a flipped
valid conv is held against the port's ConvTranspose1d.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcvits_tpu.models.flow import ResidualCouplingBlock as JaxFlow
from vcvits_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from vcvits_tpu.streaming_conv import StreamingFlowDecoder as JaxSFD
from vcvits_tpu_torch.config import ModelConfig
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.flow import ResidualCouplingBlock
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
from vcvits_tpu_torch.models.layers import ConvTranspose1d
from vcvits_tpu_torch.streaming_conv import (
    S, StreamingFlowDecoder, _convtranspose1d_kernel, _Ctx, _sconv, _sstuff)

torch.set_num_threads(1)

INTER, HIDDEN, GIN = 8, 16, 4
RATES, KS = (4, 2), (8, 4)
RES_K, RES_D = (3, 7), ((1, 3), (1, 5))
UP0 = 32
CHUNK, T = 16, 32
TOL = dict(atol=1e-5, rtol=1e-4)
MODEL = ModelConfig(inter_channels=INTER, hidden_channels=HIDDEN, gin_channels=GIN,
                    resblock="1", resblock_kernel_sizes=RES_K, resblock_dilation_sizes=RES_D,
                    upsample_rates=RATES, upsample_kernel_sizes=KS, upsample_initial_channel=UP0)


def _random_params(module, *args, seed, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                        shapes)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    z_p = rng.standard_normal((1, T, INTER)).astype(np.float32)
    g = rng.standard_normal((1, GIN)).astype(np.float32)
    jflow = JaxFlow(INTER, HIDDEN, 5, 1, 4, gin_channels=GIN)
    jdec = JaxGenerator(initial_channel=INTER, resblock="1", resblock_kernel_sizes=RES_K,
                        resblock_dilation_sizes=RES_D, upsample_rates=RATES,
                        upsample_initial_channel=UP0, upsample_kernel_sizes=KS,
                        gin_channels=GIN, fold_tail=False)
    mask = np.ones((1, T, 1), np.float32)
    pf = _random_params(jflow, z_p, mask, g=g, seed=1)
    pd = _random_params(jdec, z_p, g=g, seed=2)
    flow = ResidualCouplingBlock(INTER, HIDDEN, 5, 1, 4, gin_channels=GIN)
    flow.load_state_dict(params_from_jax(pf))
    dec = HiFiGANGenerator(INTER, "1", RES_K, RES_D, RATES, UP0, KS, gin_channels=GIN)
    dec.load_state_dict(params_from_jax(pd))
    gen = SimpleNamespace(flow=flow, dec=dec)
    return dict(z_p=z_p, g=g, jflow=jflow, jdec=jdec, pf=pf, pd=pd, gen=gen)


def _port_streamed(gen, z_p, g, chunk):
    sfd = StreamingFlowDecoder(MODEL, chunk).bind(gen)
    state = sfd.init_state()
    zt, gt = torch.from_numpy(z_p), torch.from_numpy(g)
    pieces = []
    for i in range(T // chunk):
        y, state = sfd.step(state, zt[:, i * chunk:(i + 1) * chunk], gt)
        pieces.append(y[0, :, 0].numpy())
    for _ in range(sfd.flush_chunks()):
        y, state = sfd.step(state, torch.zeros(1, chunk, INTER), gt, total_frames=T)
        pieces.append(y[0, :, 0].numpy())
    return np.concatenate(pieces)[sfd.delay_samples:], sfd, state


def test_streamed_equals_port_offline(models):
    gen, z_p, g = models["gen"], models["z_p"], models["g"]
    with torch.no_grad():
        zt, gt = torch.from_numpy(z_p), torch.from_numpy(g)
        mask = torch.ones(1, T, 1)
        z = gen.flow.kernel_reverse(zt, mask, g=gt) * mask
        ref = gen.dec(z, g=gt, fused_mrf=True)[0, :, 0].numpy()
    got, _, _ = _port_streamed(gen, z_p, g, CHUNK)
    assert len(got) >= len(ref) == T * 8
    assert np.abs(ref).mean() > 1e-2  # not silent
    np.testing.assert_allclose(got[:len(ref)], ref, **TOL)


def test_streamed_equals_jax_streamed(models):
    m = models
    jmodel = SimpleNamespace(
        inter_channels=INTER, hidden_channels=HIDDEN, gin_channels=GIN, resblock="1",
        resblock_kernel_sizes=RES_K, resblock_dilation_sizes=RES_D, upsample_rates=RATES,
        upsample_kernel_sizes=KS)
    params = {"flow": m["pf"], "dec": m["pd"]}
    jsfd = JaxSFD(jmodel, params, CHUNK)
    jsfd.bind(params)
    state = jsfd.init_state()
    z_p, g = jnp.asarray(m["z_p"]), jnp.asarray(m["g"])
    pieces = []
    for i in range(T // CHUNK):
        y, state = jsfd.step(state, z_p[:, i * CHUNK:(i + 1) * CHUNK], g)
        pieces.append(np.asarray(y)[0, :, 0])
    for _ in range(jsfd.flush_chunks()):
        y, state = jsfd.step(state, jnp.zeros((1, CHUNK, INTER)), g, total_frames=T)
        pieces.append(np.asarray(y)[0, :, 0])
    ref = np.concatenate(pieces)[jsfd.delay_samples:]
    got, sfd, _ = _port_streamed(m["gen"], m["z_p"], m["g"], CHUNK)
    assert sfd.delay_samples == jsfd.delay_samples and sfd.flush_chunks() == jsfd.flush_chunks()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_state_is_fixed_size_and_small(models):
    sfd = StreamingFlowDecoder(MODEL, 8).bind(models["gen"])
    state = sfd.init_state()
    shapes0 = {k: tuple(v.shape) for k, v in state.items() if k != "__n"}
    z = torch.ones(1, 8, INTER)
    g = torch.from_numpy(models["g"])
    for _ in range(5):
        _, state = sfd.step(state, z, g)
    shapes5 = {k: tuple(v.shape) for k, v in state.items() if k != "__n"}
    assert shapes0 == shapes5 and state["__n"] == 5
    # the buffers hold halos and delays, not the audio streamed so far
    assert sum(np.prod(s) for s in shapes5.values()) < 20_000


def test_transposed_conv_as_stuffed_flipped_conv():
    """ConvTranspose1d(stride u, padding (k-u)//2) == a valid conv of the
    flipped kernel over the zero-stuffed input, left-padded k-1-pad."""
    rng = np.random.default_rng(3)
    u, k, cin, cout, f = 4, 8, 6, 5, 12
    up = ConvTranspose1d(cin, cout, k, stride=u, padding=(k - u) // 2, weight_norm=True)
    with torch.no_grad():
        for p in up.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, f, cin)).astype(np.float32))
    with torch.no_grad():
        ref = up(x)[0].numpy()  # [(f-1)u + k - 2 pad, cout] = [f*u, cout]
        ctx = _Ctx(None, 0, 1, torch.float32, torch.device("cpu"), {}, total_frames=f)
        s = _sstuff(S(x.transpose(1, 2), 0, f, 1), u)
        got = _sconv(ctx, s, "up", *_convtranspose1d_kernel(up, torch.float32),
                     pl=k - 1 - (k - u) // 2)
    lead = got.D  # the streamed output is the offline one delayed by D frames
    out = got.x[0].T.numpy()[lead:]
    np.testing.assert_allclose(out, ref[:len(out)], atol=1e-5, rtol=1e-5)
    assert len(out) == f * u - lead
