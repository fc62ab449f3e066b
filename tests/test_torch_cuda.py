"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the plain version runs with TF32 off and K1 with 3xTF32 (about
2^-21 relative per product), so in float32 they differ by rounding at the
level of the summation order: max |err| <= 1e-4 x the output's RMS, and
K1 also <= 1e-5, which one TF32 product per multiply-add cannot meet. bf16 weights
round the conv inputs to bf16 on both sides; where the two sums land on
either side of a bf16 step the input moves by 2^-8 relative, and that
spreads through the chained convs: the error's RMS <= 2e-2 x the output's
RMS. The STFT kernel (K3) takes an FFT where the plain version sums a
direct DFT by float64 matmul: spec max |err| <= 1e-4 x max |spec|,
log-mel max |err| <= 1e-4. The mel-only instance (K4) runs K3's FFT and
band sums without writing the spectrogram: log-mel max |err| <= 1e-4
against the plain version and <= 1e-6 against K3's mel at the same tile.
Both are checked at both frame tiles, at n_fft 2048, 1024 and 512 and at
256 mels, where the lowest filters are narrower than a bin and the
log-mel is held to 1e-4 against the plain version and against a float64
NumPy FFT as well. A size the kernel does not take raises on a CUDA tensor. The gate
(K5) is elementwise in fp32: forward and gradients <= 1e-6. The WaveNet
kernel (K2) runs 3xTF32 like K1: its three modes (coupling reverse and
forward, a WaveNet segment) are held to max |err| <= 1e-4 x the output's
RMS against the plain version, at hidden 64, 128 and 256. At the serving
daemon's largest batch (16 rows) K1 is held at two stages of a 10 s
request in fp32 and bf16 (each row also against its run alone) and K2's
reverse at [16, 930, 128] with a ragged mask, at the same tolerances; a
daemon batch of 4 on the card matches each request's solo conversion to
1e-3 absolute. The W8A8 int8 conv (Q1) sums exact integers, as its plain
version does in float64, and dequantizes in the same float32 order: its
outputs are within 1 ulp of the output type; its rows' maxima (Q2) and
the scales made on the card are the plain version's bit for bit. The
monotonic alignment search (M1) makes the same float32 adds as its plain
version, in the same order: its path is bit-equal, at the TTS step's
shapes and at T_x above the block size (and with its decisions in the
global scratch). TTS `infer` on the card matches the CPU's plain path at
noise 0 to 1e-3 absolute, with equal lengths, masks and alignment. The
train step's source smoothing repeats itself bit for bit on the card.
"""

import numpy as np
import pytest
import torch

from vcvits_tpu_torch.dsp.spectrogram import _padded_window, mel_filterbank
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.flow_coupling import (
    coupling_forward, coupling_forward_plain, coupling_reverse, coupling_reverse_plain,
    wn_segment, wn_segment_plain)
from vcvits_tpu_torch.ops.flow_coupling import kernel_plan as flow_kernel_plan
from vcvits_tpu_torch.ops.flow_coupling import plan as flow_plan
from vcvits_tpu_torch.ops.fused_gate import fused_add_tanh_sigmoid_multiply, fused_gate
from vcvits_tpu_torch.ops.mrf import kernel_plan, launches_per_stage, mrf, mrf_plain, plan
from vcvits_tpu_torch.ops.stft_mel import MEL_ONLY, SPEC_MEL, SPEC_ONLY
from vcvits_tpu_torch.ops.stft_mel import _launch as stft_launch
from vcvits_tpu_torch.ops.stft_mel import (
    mel_spectrogram, mel_spectrogram_plain, spectrogram, spectrogram_mel, spectrogram_mel_plain,
    spectrogram_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mrf_inputs(rng, c, t, ks, ds, wdtype, dev, batch=1):
    x = torch.tensor(rng.standard_normal((batch, t, c)), dtype=torch.float32, device=dev)
    blocks = []
    for k, dil in zip(ks, ds):
        n = len(dil)
        scale = 1.0 / np.sqrt(k * c)
        blocks.append(tuple(
            torch.tensor(rng.standard_normal(shape) * s, dtype=torch.float32, device=dev)
            .to(wdtype).contiguous()
            for shape, s in (((n, k, c, c), scale), ((n, c), 0.1),
                             ((n, k, c, c), scale), ((n, c), 0.1))))
    return x, blocks


def _rel_err(got, ref, bf16=False):
    ref = ref.float()
    diff = got.float() - ref
    err = diff.pow(2).mean().sqrt() if bf16 else diff.abs().max()
    return err.item() / max(ref.pow(2).mean().sqrt().item(), 1e-6)


# (C, T, batch): every stage width; T below the 30-row halo of k 11 at d 5,
# ragged T, and T one row past a tile (54 output rows at C 256 and k 11, 118
# at C 128, 502 at C 32), where a bias leaking into u's padding would show
MRF_CASES = [(32, 1000, 1), (64, 333, 2), (256, 97, 1), (128, 20, 1), (256, 55, 1),
             (128, 119, 2), (32, 503, 1), (64, 1001, 1)]


@pytest.mark.parametrize("c,t,batch", MRF_CASES)
@pytest.mark.parametrize("wdtype,tol", [(torch.float32, 1e-4), (torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_mrf_kernel_matches_plain(dev, c, t, batch, wdtype, tol):
    """fp32 is held to 1e-5 x RMS as well, which one TF32 product per
    multiply-add (10-bit mantissa, about 1e-3 relative) cannot meet: the
    kernel runs 3xTF32."""
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    x, blocks = _mrf_inputs(np.random.default_rng(c + t), c, t, ks, ds, wdtype, dev, batch)
    before = _build.LAUNCHES["mrf"]
    got = mrf(x, blocks, ks, ds)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mrf"] - before == launches_per_stage(ds) == 9
    ref = mrf_plain(x, blocks, ks, ds)
    assert got.shape == ref.shape and got.dtype == x.dtype
    assert _rel_err(got, ref, bf16=wdtype == torch.bfloat16) < tol


def test_mrf_kernel_bf16_activations(dev):
    ks, ds = (3, 5), ((1, 2), (1,))
    x, blocks = _mrf_inputs(np.random.default_rng(3), 64, 500, ks, ds, torch.bfloat16, dev)
    x = x.to(torch.bfloat16)
    got = mrf(x, blocks, ks, ds)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got, mrf_plain(x, blocks, ks, ds), bf16=True) < 2e-2


@pytest.mark.parametrize("c", [96, 160])
def test_mrf_kernel_generic_block(dev, c):
    """The (5, 2) block and a one-dilation block at batch 2, fp32, at widths
    that are not powers of two (6 and 5 warps a block)."""
    ks, ds = (3, 5), ((1, 2), (1,))
    x, blocks = _mrf_inputs(np.random.default_rng(c), c, 300, ks, ds, torch.float32, dev, 2)
    before = _build.LAUNCHES["mrf"]
    got = mrf(x, blocks, ks, ds)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mrf"] - before == launches_per_stage(ds) == 3
    assert _rel_err(got, mrf_plain(x, blocks, ks, ds)) < 1e-5


@pytest.mark.parametrize("c,k,d", [(48, 3, 1), (512, 3, 1), (64, 4, 1), (256, 11, 60)])
def test_mrf_kernel_rejects_unsupported_width(dev, c, k, d):
    """C not a multiple of 32, above 256, an even kernel, or a tile whose
    shared memory passes 227 KB: ValueError before any launch, no fallback."""
    ks, ds = (k,), ((d,),)
    x, blocks = _mrf_inputs(np.random.default_rng(4), c, 64, ks, ds, torch.float32, dev)
    before = _build.LAUNCHES["mrf"]
    with pytest.raises(ValueError):
        mrf(x, blocks, ks, ds)
    assert _build.LAUNCHES["mrf"] == before


def test_mrf_plan_matches_kernel(dev):
    """ops/mrf.py:plan and the library's mrf_plan agree on every stage shape
    and on the refusals."""
    for c in range(32, 257, 32):
        for k, d in ((3, 1), (7, 3), (11, 5), (5, 2), (11, 40)):
            for wdt in (torch.float32, torch.bfloat16):
                try:
                    p = plan(c, k, d, wdt)
                except ValueError:
                    with pytest.raises(ValueError):
                        kernel_plan(c, k, d, wdt)
                    continue
                assert (p.threads, p.rows, p.smem) == kernel_plan(c, k, d, wdt)


def _flow_inputs(rng, batch, t, c, hidden, n_layers, dev, with_cond):
    half = c // 2
    shapes = ((half, hidden), (hidden,), (n_layers, 5, hidden, 2 * hidden),
              (n_layers, 2 * hidden), (n_layers, hidden, 2 * hidden), (n_layers, 2 * hidden),
              (hidden, half), (half,))
    weights = tuple(torch.tensor(rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1 else 4),
                                 dtype=torch.float32, device=dev) for s in shapes)
    x = torch.tensor(rng.standard_normal((batch, t, c)), dtype=torch.float32, device=dev)
    lens = torch.tensor([t - 7 * i for i in range(batch)], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()[..., None]
    cond = (torch.tensor(rng.standard_normal((batch, n_layers * 2 * hidden)) * 0.3,
                         dtype=torch.float32, device=dev) if with_cond else None)
    return x, mask, cond, weights


# T below one 64-frame tile, 64k + 1, and 150 (ragged rows t, t - 7, t - 14)
@pytest.mark.parametrize("t", [37, 129, 150])
@pytest.mark.parametrize("with_cond", [True, False])
def test_flow_kernel_matches_plain(dev, t, with_cond):
    x, mask, cond, w = _flow_inputs(np.random.default_rng(t), 3, t, 32, 64, 4, dev, with_cond)
    before = _build.LAUNCHES["flow_coupling_reverse"]
    got = coupling_reverse(x, mask, cond, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flow_coupling_reverse"] - before == 1
    ref = coupling_reverse_plain(x, mask, cond, w)
    assert _rel_err(got, ref) < 1e-4


def test_flow_kernel_full_width(dev):
    """The main path's shape: [1, 930, 128], hidden 128, 4 layers."""
    x, mask, cond, w = _flow_inputs(np.random.default_rng(9), 1, 930, 128, 128, 4, dev, True)
    got = coupling_reverse(x, mask, cond, w)
    assert _rel_err(got, coupling_reverse_plain(x, mask, cond, w)) < 1e-4


@pytest.mark.parametrize("hidden,c", [(256, 256), (192, 192)])
def test_flow_kernel_wide(dev, hidden, c):
    """configs/base.json's flow (hidden 256, 32 channels a CTA, a cluster of
    8) and hidden 192 (a cluster of 6), ragged batch 2."""
    x, mask, cond, w = _flow_inputs(np.random.default_rng(hidden), 2, 300, c, hidden, 4, dev,
                                    True)
    got = coupling_reverse(x, mask, cond, w)
    assert _rel_err(got, coupling_reverse_plain(x, mask, cond, w)) < 1e-4


@pytest.mark.parametrize("b,t,hidden", [(1, 930, 128), (2, 129, 64), (2, 200, 256)])
def test_flow_forward_kernel_matches_plain(dev, b, t, hidden):
    x, mask, cond, w = _flow_inputs(np.random.default_rng(t + 1), b, t, hidden, hidden, 4, dev,
                                    True)
    before = _build.LAUNCHES["flow_coupling_forward"]
    got = coupling_forward(x, mask, cond, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flow_coupling_forward"] - before == 1
    assert _rel_err(got, coupling_forward_plain(x, mask, cond, w)) < 1e-4


@pytest.mark.parametrize("b,t,hidden,n_layers,with_cond", [(1, 930, 128, 4, True),
                                                           (2, 129, 128, 4, False),
                                                           (2, 77, 64, 3, True),
                                                           (1, 300, 256, 4, True)])
def test_wn_segment_kernel_matches_plain(dev, b, t, hidden, n_layers, with_cond):
    rng = np.random.default_rng(t + hidden)
    x, mask, cond, w = _flow_inputs(rng, b, t, 2 * hidden, hidden, n_layers, dev, with_cond)
    h = torch.tensor(rng.standard_normal((b, t, hidden)), dtype=torch.float32, device=dev) * mask
    skip = torch.tensor(rng.standard_normal((b, t, hidden)), dtype=torch.float32, device=dev)
    before = _build.LAUNCHES["wn_segment"]
    got = wn_segment(h, skip, mask, cond, w[2:6])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wn_segment"] - before == 1
    for g, r in zip(got, wn_segment_plain(h, skip, mask, cond, w[2:6])):
        assert g.dtype == torch.float32 and _rel_err(g, r) < 1e-4


def test_flow_kernel_refuses(dev):
    """A width the kernel does not take, and a tensor that requires grad,
    raise on a CUDA tensor: no fallback to the plain version."""
    x, mask, cond, w = _flow_inputs(np.random.default_rng(3), 1, 40, 48, 96, 4, dev, True)
    with pytest.raises(ValueError, match="multiple of 64"):
        coupling_reverse(x, mask, cond, w)
    x, mask, cond, w = _flow_inputs(np.random.default_rng(3), 1, 40, 32, 64, 4, dev, True)
    with pytest.raises(ValueError, match="no backward"):
        coupling_forward(x.requires_grad_(), mask, cond, w)


def test_flow_plan_matches_kernel(dev):
    for hidden in (32, 64, 96, 128, 192, 256, 320):
        for k, layers, half in ((5, 4, 64), (5, 4, None), (3, 4, 16), (5, 16, None),
                                (7, 4, 128)):
            try:
                p = flow_plan(hidden, k, layers, half)
            except ValueError:
                with pytest.raises(ValueError):
                    flow_kernel_plan(hidden, k, layers, half)
                continue
            assert (p.cluster, p.tile, p.smem) == flow_kernel_plan(hidden, k, layers, half)


def _wave(rng, b, t, dev):
    n = np.arange(t) / 48000.0
    tone = sum(0.2 / (h + 1) * np.sin(2 * np.pi * 180.0 * (h + 1) * n) for h in range(8))
    y = tone[None, :] + 0.02 * rng.standard_normal((b, t))
    return torch.tensor(y, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("b,t,tile", [(3, 48000, None), (1, 7000, 1), (2, 20480, 1),
                                      (2, 20480, 2), (1, 769, 2)])
def test_stft_mel_kernel_matches_plain(dev, b, t, tile):
    y = _wave(np.random.default_rng(t), b, t, dev)
    args = (2048, 128, 48000, 512, 2048)
    before = _build.LAUNCHES["stft_mel"]
    if tile is None:  # the wrapper, with the tile it picks
        spec, mel = spectrogram_mel(y, *args)
    else:
        spec, mel = stft_launch(y, SPEC_MEL, 2048, 512, 2048, 128, 48000, tile=tile)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stft_mel"] - before == 1
    ref_spec, ref_mel = spectrogram_mel_plain(y, *args)
    assert spec.shape == ref_spec.shape == (b, 1 + (t - 512) // 512, 1025)
    assert mel.shape == (b, spec.shape[1], 128)
    assert (spec - ref_spec).abs().max().item() <= 1e-4 * ref_spec.abs().max().item()
    assert (mel - ref_mel).abs().max().item() <= 1e-4
    only = (spectrogram(y, 2048, 512, 2048) if tile is None else
            stft_launch(y, SPEC_ONLY, 2048, 512, 2048, tile=tile)[0])
    assert (only - ref_spec).abs().max().item() <= 1e-4 * ref_spec.abs().max().item()
    np.testing.assert_allclose(only.cpu().numpy(), spectrogram_plain(y, 2048, 512, 2048)
                               .cpu().numpy(), atol=1e-4 * ref_spec.abs().max().item())


def test_stft_mel_kernel_refuses_grad(dev):
    y = _wave(np.random.default_rng(0), 1, 4096, dev).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        spectrogram_mel(y, 2048, 128, 48000, 512, 2048)


@pytest.mark.parametrize("b,t", [(1, 480000), (2, 20480), (1, 769)])
@pytest.mark.parametrize("tile", [1, 2])
def test_mel_kernel_matches_plain_and_k3(dev, b, t, tile):
    """K4 at each tile: a 10 s clip (937 frames, a ragged last tile at two
    frames a block), a short batch, and the shortest clip the reflect pad
    takes (one frame)."""
    y = _wave(np.random.default_rng(t + tile), b, t, dev)
    n4, n3 = _build.LAUNCHES["mel_spectrogram"], _build.LAUNCHES["stft_mel"]
    spec, mel = stft_launch(y, MEL_ONLY, 2048, 512, 2048, 128, 48000, tile=tile)
    torch.cuda.synchronize()
    assert spec is None
    assert (_build.LAUNCHES["mel_spectrogram"] - n4, _build.LAUNCHES["stft_mel"] - n3) == (1, 0)
    ref = mel_spectrogram_plain(y, 2048, 128, 48000, 512, 2048)
    assert mel.shape == ref.shape == (b, 1 + (t - 512) // 512, 128)
    assert (mel - ref).abs().max().item() <= 1e-4
    k3_mel = stft_launch(y, SPEC_MEL, 2048, 512, 2048, 128, 48000, tile=tile)[1]
    assert (mel - k3_mel).abs().max().item() <= 1e-6


# (n_fft, hop, win, n_mels, sr, fmin, fmax): the tests' small configs and
# configs/base.json's 256 mels
STFT_SIZES = {"1024 16k": (1024, 256, 800, 40, 16000, 30.0, 7000.0),
              "1024 48k": (1024, 512, 1024, 8, 48000, 0.0, None),
              "512": (512, 256, 512, 8, 48000, 0.0, None),
              "2048 256 mels": (2048, 512, 2048, 256, 48000, 0.0, None)}


def _log_mel64(y, n_fft, hop, win, n_mels, sr, fmin, fmax):
    """The log-mel in float64 NumPy (reflect pad, rfft, the 1e-6 floor, the
    dense fbank product), on the host."""
    pad = (n_fft - hop) // 2
    yp = np.pad(y.double().cpu().numpy(), ((0, 0), (pad, pad)), mode="reflect")
    nf = 1 + (yp.shape[1] - n_fft) // hop
    frames = np.stack([yp[:, f * hop:f * hop + n_fft] for f in range(nf)], axis=1)
    x = np.fft.rfft(frames * _padded_window(n_fft, win, np.float64), axis=-1)
    spec = np.sqrt(x.real ** 2 + x.imag ** 2 + 1e-6)
    fbank = mel_filterbank(sr, n_fft, n_mels, fmin, fmax).astype(np.float64)
    return np.log(np.maximum(spec @ fbank.T, 1e-5))


@pytest.mark.parametrize("tile", [1, 2])
@pytest.mark.parametrize("name", list(STFT_SIZES))
def test_stft_kernel_other_sizes(dev, name, tile):
    """The three instances at the other sizes the repo runs, 2 x 0.3 s:
    spec and log-mel against the plain version, log-mel against a float64
    NumPy FFT too."""
    n_fft, hop, win, n_mels, sr, fmin, fmax = STFT_SIZES[name]
    y = _wave(np.random.default_rng(n_fft + n_mels), 2, 14400, dev)
    spec, mel = stft_launch(y, SPEC_MEL, n_fft, hop, win, n_mels, sr, fmin, fmax, tile=tile)
    only = stft_launch(y, SPEC_ONLY, n_fft, hop, win, tile=tile)[0]
    mel4 = stft_launch(y, MEL_ONLY, n_fft, hop, win, n_mels, sr, fmin, fmax, tile=tile)[1]
    torch.cuda.synchronize()
    ref_spec, plain_mel = spectrogram_mel_plain(y, n_fft, n_mels, sr, hop, win, fmin, fmax)
    ref_mel = _log_mel64(y, n_fft, hop, win, n_mels, sr, fmin, fmax)
    assert spec.shape == only.shape == ref_spec.shape == (2, 1 + (14400 - hop) // hop,
                                                          n_fft // 2 + 1)
    assert mel.shape == mel4.shape == ref_mel.shape
    top = ref_spec.abs().max().item()
    assert (spec - ref_spec).abs().max().item() <= 1e-4 * top
    assert (only - ref_spec).abs().max().item() <= 1e-4 * top
    assert (mel - plain_mel).abs().max().item() <= 1e-4
    np.testing.assert_allclose(mel.cpu().numpy(), ref_mel, rtol=0, atol=1e-4)
    assert (mel4 - mel).abs().max().item() <= 1e-6


def test_stft_kernel_refuses_sizes_it_does_not_take(dev):
    """A CUDA tensor at n_fft 1536 or with 257 mels raises; nothing runs the
    plain version on the card instead."""
    y = _wave(np.random.default_rng(5), 1, 9600, dev)
    before = dict(_build.LAUNCHES)
    for call in (lambda: spectrogram(y, 1536, 512, 1536),
                 lambda: spectrogram_mel(y, 1536, 128, 48000, 512, 1536),
                 lambda: mel_spectrogram(y, 1536, 128, 48000, 512, 1536)):
        with pytest.raises(ValueError, match="power of two"):
            call()
    with pytest.raises(ValueError, match="1 to 256 mels"):
        mel_spectrogram(y, 2048, 257, 48000, 512, 2048)
    assert dict(_build.LAUNCHES) == before


def test_mel_wrapper_launches_once_and_refuses_grad(dev):
    y = _wave(np.random.default_rng(2), 1, 48000, dev)
    before = _build.LAUNCHES["mel_spectrogram"]
    got = mel_spectrogram(y, 2048, 128, 48000, 512, 2048)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mel_spectrogram"] - before == 1
    assert (got - mel_spectrogram_plain(y, 2048, 128, 48000, 512, 2048)).abs().max().item() <= 1e-4
    with pytest.raises(ValueError, match="no backward"):
        mel_spectrogram(y.clone().requires_grad_(), 2048, 128, 48000, 512, 2048)


@pytest.mark.parametrize("b_kind", ["broadcast", "none"])
@pytest.mark.parametrize("shape", [(16, 282, 128), (3, 77, 16)])
def test_fused_gate_kernel_matches_plain(dev, b_kind, shape):
    bsz, t, h = shape
    rng = np.random.default_rng(t)
    a = torch.tensor(rng.standard_normal((bsz, t, 2 * h)), dtype=torch.float32, device=dev)
    b = {"broadcast": (bsz, 1, 2 * h), "none": None}[b_kind]
    b = None if b is None else torch.tensor(rng.standard_normal(b), dtype=torch.float32,
                                            device=dev)
    go = torch.tensor(rng.standard_normal((bsz, t, h)), dtype=torch.float32, device=dev)

    def run(fn):
        a_ = a.clone().requires_grad_()
        b_ = None if b is None else b.clone().requires_grad_()
        out = fn(a_, b_, h)
        out.backward(go)
        return out, a_.grad, None if b_ is None else b_.grad

    n0, n1 = _build.LAUNCHES["fused_gate"], _build.LAUNCHES["fused_gate_backward"]
    got = run(fused_gate)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["fused_gate"] - n0, _build.LAUNCHES["fused_gate_backward"] - n1) \
        == (1, 1)
    ref = run(fused_add_tanh_sigmoid_multiply)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        tol = 1e-6 * (t if g.shape[1] == 1 else 1)  # grad_b sums t terms
        assert g.shape == r.shape and (g - r).abs().max().item() <= tol


def test_fused_gate_kernel_bf16(dev):
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((2, 50, 64)), device=dev).to(torch.bfloat16)
    b = torch.tensor(rng.standard_normal((2, 1, 64)), device=dev).to(torch.bfloat16)
    got = fused_gate(a, b, 32)
    assert got.dtype == torch.bfloat16
    ref = fused_add_tanh_sigmoid_multiply(a.float(), b.float(), 32)
    assert (got.float() - ref).abs().max().item() <= 1e-2


TINY_TRAIN = {
    "train": {"segment_size": 2048, "batch_size": 2, "steps_per_epoch": 10,
              "disc_time_fold": False},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 8},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0, "hubert_channels": 16,
              "num_pitch": 64, "gin_channels": 4, "upsample_initial_channel": 32,
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "multi_period_discriminator_periods": [2, 3]},
}


def test_train_step_on_card_matches_cpu(dev):
    """One tiny TrainStep on the card (K3, K5 with its backward) and on the
    CPU (plain versions), same weights, batch and draws: every metric to
    rtol 1e-3; the kernels' launches per step; the section timings."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.train.step import StepDraws, TrainStep

    cfg = Config.from_dict(TINY_TRAIN)
    hub = HubertConfig(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16,
                       num_layers=1, num_heads=2, intermediate_size=32, pos_conv_kernel=8,
                       pos_conv_groups=2)
    g = np.random.default_rng(0)
    tx, ty = 5120, 15360
    batch = {"x_wav": torch.tensor(g.standard_normal((2, tx)) * 0.1, dtype=torch.float32),
             "x_wav_lengths": torch.tensor([tx, tx - 640], dtype=torch.int32),
             "x_pitch": torch.tensor(g.integers(1, 64, (2, tx // 320))),
             "y_wav": torch.tensor(g.standard_normal((2, ty)) * 0.1, dtype=torch.float32),
             "y_wav_lengths": torch.tensor([ty, ty - 2048], dtype=torch.int32),
             "sid": torch.tensor([1, 5])}
    draws = [torch.tensor(g.standard_normal((2, 30, 8)), dtype=torch.float32),
             torch.tensor([3, 20]), torch.tensor(g.standard_normal((2, 30, 8)),
                                                 dtype=torch.float32), torch.tensor([0, 17])]
    cpu = TrainStep(cfg, device="cpu", hubert_cfg=hub, seed=4)
    card = TrainStep(cfg, device=dev, hubert_cfg=hub, g_state=cpu.gen.state_dict(),
                     d_state=cpu.disc.state_dict())
    before = dict(_build.LAUNCHES)
    parts = {}
    got = card({k: v.to(dev) for k, v in batch.items()},
               StepDraws(*(d.to(dev) for d in draws)), timings=parts)
    rose = {k: _build.LAUNCHES[k] - before.get(k, 0)
            for k in ("stft_mel", "fused_gate", "fused_gate_backward")}
    assert rose == {"stft_mel": 1, "fused_gate": 64, "fused_gate_backward": 32}
    assert len(parts) == 9 and all(v > 0 for v in parts.values())
    ref = cpu(batch, StepDraws(*draws))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-3, atol=1e-6, err_msg=k)


# The serving daemon's largest batch: 16 rows, each stage of a 10 s request
@pytest.mark.parametrize("t,c", [(7440, 256), (476160, 32)])
@pytest.mark.parametrize("wdtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_mrf_kernel_at_serving_batch(dev, t, c, wdtype, tol):
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    x, blocks = _mrf_inputs(np.random.default_rng(c), c, t, ks, ds, wdtype, dev, batch=16)
    before = _build.LAUNCHES["mrf"]
    got = mrf(x, blocks, ks, ds)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mrf"] - before == 9
    ref = mrf_plain(x, blocks, ks, ds)
    assert got.shape == (16, t, c) and torch.isfinite(got).all()
    assert _rel_err(got, ref, bf16=wdtype == torch.bfloat16) < tol
    # every row alone, too: no row of the batch reads another's frames
    for row in (0, 15):
        alone = mrf(x[row:row + 1].contiguous(), blocks, ks, ds)
        assert _rel_err(got[row:row + 1], alone, bf16=wdtype == torch.bfloat16) < tol


def test_flow_reverse_at_serving_batch_ragged(dev):
    """4 couplings (with flips) at [16, 930, 128], hidden 128, each row its
    own length drawn from 186-930 (a padded daemon batch)."""
    rng = np.random.default_rng(16)
    x, _, _, _ = _flow_inputs(rng, 16, 930, 128, 128, 4, dev, True)
    couplings = [_flow_inputs(rng, 16, 930, 128, 128, 4, dev, True)[2:] for _ in range(4)]
    lens = torch.tensor(rng.integers(186, 931, 16), device=dev)
    mask = (torch.arange(930, device=dev)[None, :] < lens[:, None]).float()[..., None]

    def chain(fn):
        y = x
        for cond, w in couplings:
            y = fn(torch.flip(y, dims=[-1]).contiguous(), mask, cond, w)
        return y

    before = _build.LAUNCHES["flow_coupling_reverse"]
    got = chain(coupling_reverse)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flow_coupling_reverse"] - before == 4
    assert _rel_err(got, chain(coupling_reverse_plain)) < 1e-4


SERVE_CFG = {
    "data": {"n_speakers": 8},
    "model": {"inter_channels": 16, "hidden_channels": 64, "filter_channels": 64,
              "n_heads": 2, "n_layers": 1, "hubert_channels": 16, "num_pitch": 512,
              "gin_channels": 8, "upsample_rates": [8, 8, 8], "upsample_kernel_sizes": [16, 16, 16],
              "upsample_initial_channel": 256, "p_dropout": 0.0},
}


def test_daemon_batch_rows_match_solo_on_card(dev):
    """A ServingDaemon batch of 4 equal-length requests on the card (K2 4
    launches and K1 27 for the whole batch) against each request's solo
    convert_array, noise_scale 0: every row within 1e-3."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.serving import ServingDaemon

    hub = HubertConfig(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16,
                       num_layers=1, num_heads=2, intermediate_size=32, pos_conv_kernel=8,
                       pos_conv_groups=2)
    vc = VoiceConverter(Config.from_dict(SERVE_CFG), device=dev, hubert_cfg=hub, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # a non-identity flow and an audible decoder
        for name, p in vc.gen.named_parameters():
            if name.startswith("flow.") and ".post." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.startswith("dec.") and name.endswith(".g"):
                p.mul_(3.0)
    rng = np.random.default_rng(2)
    n = 48000
    reqs = [((0.3 * np.sin(2 * np.pi * f * np.arange(n) / 16000)
              + 0.02 * rng.standard_normal(n)).astype(np.float32),
             rng.integers(1, 512, n // 320), sid) for f, sid in ((150, 1), (210, 3), (260, 5),
                                                                 (330, 7))]
    solo = [vc.convert_array(w, p, sid, noise_scale=0.0) for w, p, sid in reqs]
    before = dict(_build.LAUNCHES)
    with ServingDaemon(vc, max_batch=4, window_ms=500) as daemon:
        outs = [f.result(timeout=300) for f in
                [daemon.submit(w, p, n, sid, noise_scale=0.0) for w, p, sid in reqs]]
        sizes = list(daemon._batch_sizes)
    assert sizes == [4]
    rose = {k: _build.LAUNCHES[k] - before.get(k, 0) for k in ("flow_coupling_reverse", "mrf")}
    assert rose == {"flow_coupling_reverse": 4, "mrf": 27}
    for got, want in zip(outs, solo):
        assert got.shape == want.shape and np.abs(want).mean() > 1e-3
        assert np.abs(got - want).max() <= 1e-3


# ---------------------------------------------------------------- Q1 / Q2
# The W8A8 int8 conv (csrc/int8_conv.cu) against its plain version
# (ops/int8_conv.py): Q2's row maxima bit-equal; Q1's integer sums are
# exact on both sides and the dequantization is the same float32
# arithmetic in the same order, so its outputs are within 1 ulp of the
# output type.

INT8_CASES = {  # Ci, Co, k, dilation, (pad_lo, pad_hi), T, B, slope
    "mrf k11 d5": (64, 64, 11, 5, (25, 25), 1000, 1, 0.1),
    "mrf ragged B=3": (32, 32, 7, 3, (9, 9), 517, 3, 0.1),
    "conv_pre": (128, 512, 7, 1, (3, 3), 200, 2, None),
    "up phase-decomposed": (256, 1024, 3, 1, (1, 1), 300, 1, 0.1),
    "conv_post": (32, 1, 7, 1, (3, 3), 1111, 2, 0.01),
    "odd widths": (30, 20, 3, 1, (1, 1), 77, 2, 0.1),
}


def _ulps(got, ref):
    """Largest distance in units in the last place of the tensors' type."""
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    a, b = (t.contiguous().view(bits).long() for t in (got, ref))
    top = 1 << (31 if bits == torch.int32 else 15)
    a, b = (torch.where(v < 0, -top - v, v) for v in (a, b))  # order like the floats
    return int((a - b).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_conv_kernel_matches_plain(dev, case, dtype):
    from vcvits_tpu_torch.ops.int8_conv import (
        conv1d_w8a8, conv1d_w8a8_plain, prepare_w8a8, row_absmax, row_absmax_plain)

    ci, co, k, d, pad, t, b, slope = INT8_CASES[case]
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((b, t, ci)), dtype=torch.float32, device=dev).to(dtype)
    x[:, -5:] *= 3.0  # the row maximum near the end of a row
    w = torch.tensor(rng.standard_normal((co, ci, k)) / np.sqrt(k * ci), dtype=torch.float32,
                     device=dev)
    bias = torch.tensor(rng.standard_normal(co) * 0.1, dtype=torch.float32, device=dev)
    qw = prepare_w8a8(w)
    amax = row_absmax(x, slope)
    assert torch.equal(amax, row_absmax_plain(x, slope))
    got = conv1d_w8a8(x, qw, pad, bias, d, slope)
    ref = conv1d_w8a8_plain(x, qw, pad, bias, d, slope)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, t + pad[0] + pad[1] - (k - 1) * d, co)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert _ulps(got, ref) <= 1
    assert conv1d_w8a8(x, qw, pad, None, d, slope).shape == ref.shape


def test_int8_conv_counts_launches_and_refuses(dev):
    from vcvits_tpu_torch.ops.int8_conv import conv1d_w8a8, kernel_plan, plan, prepare_w8a8

    x = torch.zeros(1, 64, 513, device=dev)
    with pytest.raises(ValueError):
        conv1d_w8a8(x, prepare_w8a8(torch.ones(8, 513, 3, device=dev)), (1, 1))
    with pytest.raises(ValueError):
        conv1d_w8a8(x[..., :32].contiguous(), prepare_w8a8(torch.ones(8, 32, 14, device=dev)),
                    (30, 30), dilation=5)
    with pytest.raises(ValueError):
        kernel_plan(513, 8, 3, 1)
    for ci, co, k, d in ((512, 4096, 3, 1), (256, 256, 11, 5), (1, 1, 1, 1), (30, 20, 7, 3)):
        assert kernel_plan(ci, co, k, d) == plan(ci, co, k, d).smem
    x = torch.randn(2, 100, 32, device=dev)
    before = dict(_build.LAUNCHES)
    conv1d_w8a8(x, prepare_w8a8(torch.randn(16, 32, 3, device=dev)), (1, 1), slope=0.1)
    assert {n: _build.LAUNCHES[n] - before.get(n, 0) for n in ("int8_conv1d", "row_absmax")} \
        == {"int8_conv1d": 1, "row_absmax": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 7440, 256), (3, 1001, 3), (1, 476160, 32)])
def test_row_absmax_kernel_bit_equal(dev, shape, dtype):
    from vcvits_tpu_torch.ops.int8_conv import row_absmax, row_absmax_plain

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev).to(dtype)
    for slope in (None, 0.1, 0.01):
        assert torch.equal(row_absmax(x, slope), row_absmax_plain(x, slope))


def test_int8_scales_on_card_equal_host(dev):
    """Weight and activation scales made on the card are the host's bit for
    bit (an IEEE division by 127: PyTorch would multiply a CUDA tensor by
    the reciprocal of a host scalar)."""
    from vcvits_tpu_torch.ops.int8_conv import act_scale, prepare_w8a8, row_absmax

    rng = np.random.default_rng(11)
    w = torch.tensor(rng.standard_normal((512, 64, 3)), dtype=torch.float32)
    assert torch.equal(prepare_w8a8(w.to(dev)).scale.cpu(), prepare_w8a8(w).scale)
    x = torch.tensor(rng.standard_normal((64, 300, 32)), dtype=torch.float32)
    assert torch.equal(act_scale(row_absmax(x.to(dev), 0.1)).cpu(), act_scale(row_absmax(x, 0.1)))


# ------------------------------------------------------------------ M1
def _mas_inputs(rng, b, t_x, t_y, dev, ties=False):
    v = rng.standard_normal((b, t_y, t_x)) * 30
    if ties:
        v = np.round(v / 10)
    xl = rng.integers(max(t_x // 3, 1), t_x + 1, b)
    yl = np.maximum(rng.integers(t_y // 3, t_y + 1, b), xl)
    xl[-1], yl[-1] = t_x, t_y
    return (torch.tensor(v, dtype=torch.float32, device=dev), torch.tensor(xl, device=dev),
            torch.tensor(yl, device=dev))


@pytest.mark.parametrize("b,t_x,t_y,ties", [(16, 192, 750, False), (16, 192, 750, True),
                                            (3, 700, 1500, False), (2, 1100, 2600, False),
                                            (4, 33, 5, False)])
def test_maximum_path_kernel_bit_equal(dev, b, t_x, t_y, ties):
    """The TTS step's shapes (B 16, text bucket 192, 750 frames), T_x above
    the 256-thread block, and decisions past shared memory (2 x 1100 x
    2600: the global scratch)."""
    from vcvits_tpu_torch.ops.monotonic_align import length_mask, maximum_path, \
        maximum_path_plain

    value, xl, yl = _mas_inputs(np.random.default_rng(t_x), b, t_x, t_y, dev, ties)
    before = _build.LAUNCHES["monotonic_align"]
    got = maximum_path(value, xl, yl)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["monotonic_align"] - before == 1
    ref = maximum_path_plain(value.transpose(1, 2), length_mask(xl, yl, t_x, t_y))
    assert got.shape == (b, t_x, t_y) and got.dtype == torch.float32
    assert int((got != ref).sum()) == 0


def test_maximum_path_kernel_empty_rows_and_refusals(dev):
    from vcvits_tpu_torch.ops.monotonic_align import length_mask, maximum_path, \
        maximum_path_plain

    value = torch.randn(3, 40, 9, device=dev)
    xl, yl = torch.tensor([0, 9, 4], device=dev), torch.tensor([40, 0, 60], device=dev)
    ref = maximum_path_plain(value.transpose(1, 2), length_mask(xl, yl, 9, 40))
    assert torch.equal(maximum_path(value, xl, yl), ref)
    with pytest.raises(ValueError, match="T_x"):
        maximum_path(torch.zeros(1, 10, 2049, device=dev), torch.ones(1, device=dev),
                     torch.ones(1, device=dev))
    with pytest.raises(ValueError, match="backward"):
        maximum_path(value.requires_grad_(), xl, yl)


TINY_TTS = {
    "train": {"segment_size": 2048},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 64, "hidden_channels": 64, "filter_channels": 128,
              "n_heads": 2, "n_layers": 2, "kernel_size": 3, "gin_channels": 16,
              "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]]},
}


def test_tts_infer_on_card_matches_cpu(dev):
    """SynthesizerTTS.infer at noise 0 on the card (K2 reverse, K1 decoder)
    against the CPU's plain path on the same weights: lengths, masks and
    alignment equal, the waveform to 1e-3; K2 4 and K1 launches a call."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS

    cfg = Config.from_dict(TINY_TTS)
    cpu = SynthesizerTTS.from_config(cfg, device="cpu", seed=5).eval()
    with torch.no_grad():  # off the identity flow and the near-silent decoder
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                   * 0.02)
    card = SynthesizerTTS.from_config(cfg, device=dev, seed=None).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.randint(1, 150, (2, 24), generator=torch.Generator().manual_seed(0))
    xl, sid = torch.tensor([24, 15]), torch.tensor([1, 3])
    kw = dict(noise_scale=0.0, noise_scale_w=0.0, length_scale=1.2, max_frames=160)
    ref = cpu.infer(x, xl, sid, **kw)
    before = dict(_build.LAUNCHES)
    got = card.infer(x.to(dev), xl.to(dev), sid.to(dev), **kw)
    torch.cuda.synchronize()
    rose = {k: _build.LAUNCHES[k] - before.get(k, 0) for k in ("flow_coupling_reverse", "mrf")}
    assert rose["flow_coupling_reverse"] == 4 and rose["mrf"] > 0
    assert torch.equal(got[2].cpu(), ref[2]) and torch.equal(got[1].cpu(), ref[1])
    assert ref[2].sum() > 0
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].numpy(), atol=1e-3, rtol=0)


def test_smooth_source_repeats_itself_on_card(dev):
    """The train step's source smoothing (STFT -> iSTFT; at n_fft 2048 and
    hop 512 four frames overlap each sample) gives the same samples on every
    call on the card: its overlap-add sums in a fixed order (F.fold; an
    index_add's atomics did not). It matches the CPU's to 1e-6."""
    from vcvits_tpu_torch.train.audio_pipeline import smooth_source

    x = torch.randn(4, 59200, generator=torch.Generator().manual_seed(0)) * 0.1
    first = smooth_source(x.to(dev))
    for _ in range(20):
        assert torch.equal(smooth_source(x.to(dev)), first)
    np.testing.assert_allclose(first.cpu().numpy(), smooth_source(x).numpy(), atol=1e-6, rtol=0)
