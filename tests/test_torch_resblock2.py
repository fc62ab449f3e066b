"""ResBlock2 (resblock "2": per dilation x += c_i(lrelu(x))) in the port's
HiFi-GAN decoder == JAX's.

A small decoder (two ResBlock2 blocks, kernels 3 and 5, dilations (1, 3)
and (1, 2), upsampling 4 x 2 at width 32, speaker width 4) on shared
random weights from numpy, loaded through params_from_jax (the `c_i`
names). The res blocks run as modules whatever `fused_mrf` says (K1 is
for ResBlock1 only, as in JAX): forward against JAX at atol 1e-5 / rtol
1e-4 in float32 on both paths; the gradient of a loss over the output
against jax.grad (1e-4 of each tensor's largest); W8A8 at SNR >= 60 dB;
and the cached-state streaming decoder (streaming_conv.py) against the
port's offline decoder and JAX's StreamingFlowDecoder at atol 1e-5.
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
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock2
from vcvits_tpu_torch.streaming_conv import StreamingFlowDecoder

torch.set_num_threads(1)

INTER, HIDDEN, GIN = 8, 16, 4
KW = dict(initial_channel=INTER, resblock="2", resblock_kernel_sizes=(3, 5),
          resblock_dilation_sizes=((1, 3), (1, 2)), upsample_rates=(4, 2),
          upsample_initial_channel=32, upsample_kernel_sizes=(8, 4), gin_channels=GIN)
T, CHUNK = 32, 16
TOL = dict(atol=1e-5, rtol=1e-4)


def _random_params(module, *args, seed, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                        shapes)


@pytest.fixture(scope="module")
def decoder():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, T, INTER)).astype(np.float32)
    g = rng.standard_normal((2, GIN)).astype(np.float32)
    jm = JaxGenerator(min_lanes=16, **KW)
    params = _random_params(jm, x, g, seed=1)
    tm = HiFiGANGenerator(**KW)
    tm.load_state_dict(params_from_jax(params))
    assert isinstance(tm.res_0_0, ResBlock2) and hasattr(tm.res_1_1, "c_1")
    return x, g, jm, params, tm


@pytest.mark.parametrize("fused_mrf", [True, False])
def test_resblock2_decoder_matches_jax(decoder, fused_mrf):
    x, g, jm, params, tm = decoder
    ref = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x, g))(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(g), fused_mrf=fused_mrf).numpy()
    assert got.shape == ref.shape == (2, T * 8, 1)
    assert 0.01 < np.abs(ref).mean() < 0.9
    np.testing.assert_allclose(got, ref, **TOL)


def test_resblock2_gradient_flows_like_jax(decoder):
    """d(sum of out * w)/d(params) on the training path (fused_mrf=False)."""
    x, g, jm, params, tm = decoder
    wt = np.random.default_rng(2).standard_normal((2, T * 8, 1)).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x, g) * wt)))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(x), torch.from_numpy(g), fused_mrf=False)
    (out * torch.from_numpy(wt)).sum().backward()
    ref = params_from_jax(jax.tree.map(np.asarray, jgrad))
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        scale = ref[name].abs().max().item()
        assert scale > 0, name
        assert (p.grad - ref[name]).abs().max().item() <= 1e-4 * scale, name


def test_resblock2_decoder_w8a8_matches_jax(decoder):
    x, g, _, params, _ = decoder
    jm = JaxGenerator(min_lanes=16, quant_int8=True, **KW)
    ref = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x, g))(params))
    tm = HiFiGANGenerator(quant_int8=True, **KW)
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    snr = 10 * np.log10(np.square(ref).mean() / np.square(ref - got).mean())
    assert snr >= 60.0


def test_resblock2_streams_like_offline_and_jax(decoder):
    """StreamingFlowDecoder with ResBlock2 blocks: streamed == the port's
    offline flow reverse + decoder and == JAX's streamed output."""
    rng = np.random.default_rng(3)
    z_p = rng.standard_normal((1, T, INTER)).astype(np.float32)
    g = rng.standard_normal((1, GIN)).astype(np.float32)
    jflow = JaxFlow(INTER, HIDDEN, 5, 1, 4, gin_channels=GIN)
    pf = _random_params(jflow, z_p, np.ones((1, T, 1), np.float32), g=g, seed=4)
    flow = ResidualCouplingBlock(INTER, HIDDEN, 5, 1, 4, gin_channels=GIN)
    flow.load_state_dict(params_from_jax(pf))
    _, _, _, pd, dec = decoder
    model = ModelConfig(inter_channels=INTER, hidden_channels=HIDDEN, gin_channels=GIN,
                        resblock="2", resblock_kernel_sizes=KW["resblock_kernel_sizes"],
                        resblock_dilation_sizes=KW["resblock_dilation_sizes"],
                        upsample_rates=KW["upsample_rates"],
                        upsample_kernel_sizes=KW["upsample_kernel_sizes"],
                        upsample_initial_channel=KW["upsample_initial_channel"])
    sfd = StreamingFlowDecoder(model, CHUNK).bind(SimpleNamespace(flow=flow, dec=dec))
    state = sfd.init_state()
    zt, gt = torch.from_numpy(z_p), torch.from_numpy(g)
    pieces = []
    with torch.no_grad():
        for i in range(T // CHUNK):
            y, state = sfd.step(state, zt[:, i * CHUNK:(i + 1) * CHUNK], gt)
            pieces.append(y[0, :, 0].numpy())
        for _ in range(sfd.flush_chunks()):
            y, state = sfd.step(state, torch.zeros(1, CHUNK, INTER), gt, total_frames=T)
            pieces.append(y[0, :, 0].numpy())
        got = np.concatenate(pieces)[sfd.delay_samples:]
        mask = torch.ones(1, T, 1)
        offline = dec(flow.kernel_reverse(zt, mask, g=gt) * mask, g=gt)[0, :, 0].numpy()
    assert np.abs(offline).mean() > 1e-2
    np.testing.assert_allclose(got[:len(offline)], offline, **TOL)

    jsfd = JaxSFD(SimpleNamespace(**{k: getattr(model, k) for k in (
        "inter_channels", "hidden_channels", "gin_channels", "resblock",
        "resblock_kernel_sizes", "resblock_dilation_sizes", "upsample_rates",
        "upsample_kernel_sizes")}), {"flow": pf, "dec": pd}, CHUNK)
    jsfd.bind({"flow": pf, "dec": pd})
    jstate = jsfd.init_state()
    jpieces = []
    for i in range(T // CHUNK):
        y, jstate = jsfd.step(jstate, jnp.asarray(z_p[:, i * CHUNK:(i + 1) * CHUNK]),
                              jnp.asarray(g))
        jpieces.append(np.asarray(y)[0, :, 0])
    for _ in range(jsfd.flush_chunks()):
        y, jstate = jsfd.step(jstate, jnp.zeros((1, CHUNK, INTER)), jnp.asarray(g),
                              total_frames=T)
        jpieces.append(np.asarray(y)[0, :, 0])
    ref = np.concatenate(jpieces)[jsfd.delay_samples:]
    assert sfd.delay_samples == jsfd.delay_samples and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
