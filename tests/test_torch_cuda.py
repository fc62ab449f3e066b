"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 runs with TF32 off, so kernel and plain version differ
only in summation order: max |err| <= 1e-4 x the output's RMS. bf16 weights
round the conv inputs to bf16 on both sides; where the two sums land on
either side of a bf16 step the input moves by 2^-8 relative, and that
spreads through the chained convs: the error's RMS <= 2e-2 x the output's
RMS.
"""

import numpy as np
import pytest
import torch

from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.flow_coupling import coupling_reverse, coupling_reverse_plain
from vcvits_tpu_torch.ops.mrf import launches_per_stage, mrf, mrf_plain

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


@pytest.mark.parametrize("c,t,batch", [(32, 1000, 1), (64, 333, 2), (256, 97, 1)])
@pytest.mark.parametrize("wdtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_mrf_kernel_matches_plain(dev, c, t, batch, wdtype, tol):
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    x, blocks = _mrf_inputs(np.random.default_rng(c + t), c, t, ks, ds, wdtype, dev, batch)
    before = _build.LAUNCHES["mrf"]
    got = mrf(x, blocks, ks, ds)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mrf"] - before == launches_per_stage(ds)
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


def test_mrf_kernel_rejects_unsupported_width(dev):
    ks, ds = (3,), ((1,),)
    x, blocks = _mrf_inputs(np.random.default_rng(4), 48, 64, ks, ds, torch.float32, dev)
    with pytest.raises(ValueError):
        mrf(x, blocks, ks, ds)


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


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("with_cond", [True, False])
def test_flow_kernel_matches_plain(dev, tile, with_cond):
    x, mask, cond, w = _flow_inputs(np.random.default_rng(tile), 3, 77, 8, 16, 4, dev, with_cond)
    before = _build.LAUNCHES["flow_coupling_reverse"]
    got = coupling_reverse(x, mask, cond, w, tile=tile)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flow_coupling_reverse"] - before == 1
    ref = coupling_reverse_plain(x, mask, cond, w)
    assert _rel_err(got, ref) < 1e-4


def test_flow_kernel_full_width(dev):
    """The main path's shape: [1, 930, 128], hidden 128, 4 layers."""
    x, mask, cond, w = _flow_inputs(np.random.default_rng(9), 1, 930, 128, 128, 4, dev, True)
    got = coupling_reverse(x, mask, cond, w)
    assert _rel_err(got, coupling_reverse_plain(x, mask, cond, w)) < 1e-4
