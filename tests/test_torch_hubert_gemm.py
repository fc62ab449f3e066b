"""G1's host side on the CPU: the 3xTF32 split, the weight layout, the
stream-K walk, the fused encoder layer and the dispatch rule.

* The plain version's arithmetic (tf32 hi/lo split of both operands,
  lo.hi + hi.lo + hi.hi) against a float64 product at HuBERT XTRALARGE's
  depths (K 1280 and 5120) is within 2x the error of an fp32 F.linear
  (each measured as ||y - y64|| / ||y64||); one-pass TF32 rounding, the
  control, is not.
* The fused layer (q/k/v over the concatenated weight, each epilogue) is
  the unfused EncoderLayer to fp32 rounding (atol and rtol 1e-5 at
  LayerNorm's unit scale), and a HubertModel routed through it makes
  4 x layers + 1 dense calls.
* The dispatch rule: bf16, autocast, tensor parallelism, a backward to
  record, a CPU tensor and widths G1 does not take never reach the wrapper.
* The split cached by FoldCache follows load_state_dict and in-place edits.

No JAX here; G1 itself runs in tests/test_torch_cuda.py on the card.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vcvits_tpu_torch.models.hubert import EncoderLayer, HubertConfig, HubertModel
from vcvits_tpu_torch.models.layers import Linear
from vcvits_tpu_torch.ops import hubert_gemm as g1

torch.set_num_threads(1)

LAYER = HubertConfig(conv_layers=((32, 10, 5), (32, 8, 8), (32, 8, 8)), hidden_size=128,
                     num_layers=2, num_heads=4, intermediate_size=256, pos_conv_kernel=8,
                     pos_conv_groups=4)


def rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    return ((y.double() - ref).norm() / ref.norm()).item()


def randomized(module: torch.nn.Module, seed: int, scale: float = 0.2) -> torch.nn.Module:
    """Every parameter drawn anew (biases and norms too), so that each term
    of the layer shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            base = 1.0 if name.endswith("ln1.weight") or name.endswith("ln2.weight") else 0.0
            p.copy_(base + torch.randn(p.shape, generator=gen) * scale)
    return module


def rna_f64(a: np.ndarray) -> np.ndarray:
    """Round to 10 mantissa bits, to nearest, ties away from zero (float64)."""
    m, e = np.frexp(a.astype(np.float64))
    scaled = np.abs(m) * 2.0 ** 11
    return np.sign(m) * np.floor(scaled + 0.5) / 2.0 ** 11 * 2.0 ** e


def test_split_is_two_tf32_halves():
    rng = np.random.default_rng(0)
    w = rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-6, 6, 4096)
    ties = (np.arange(1, 65, dtype=np.float32) + np.float32(0.5) * 2 ** -10)  # exact halfway
    w = torch.from_numpy(np.concatenate([w, ties, -ties, [0.0]]).astype(np.float32))
    hi, lo = g1.split(w)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    np.testing.assert_array_equal(hi.numpy(), rna_f64(w.numpy()).astype(np.float32))
    err = (w.double() - hi.double() - lo.double()).abs()
    assert bool((err <= w.double().abs() * 2.0 ** -21).all())


def test_tile_layout_is_the_swizzled_tiles():
    gen = torch.Generator().manual_seed(1)
    n, k = 256, 96
    hi, lo = torch.randn(n, k, generator=gen), torch.randn(n, k, generator=gen)
    tiles = g1.tile(hi, lo)
    assert tiles.shape == (n // 128, k // 32, 2, 128 * 32)
    rng = np.random.default_rng(2)
    for _ in range(200):
        row, col, half = int(rng.integers(n)), int(rng.integers(k)), int(rng.integers(2))
        r, c = row % 128, col % 32
        pos = r * 32 + ((c // 4) ^ (r % 8)) * 4 + c % 4
        assert tiles[row // 128, col // 32, half, pos] == (hi, lo)[half][row, col]
    flat = tiles.reshape(-1)
    assert torch.equal(flat.sort().values, torch.cat([hi, lo]).reshape(-1).sort().values)


def test_prepare_on_the_cpu_keeps_the_halves():
    w = torch.randn(128, 64)
    p = g1.prepare(w)
    hi, lo = g1.split(w)
    assert (p.n, p.k) == (128, 64)
    assert torch.equal(p.data[0], hi) and torch.equal(p.data[1], lo)


XL_DEPTHS = [(1280, 1280), (5120, 1280)]  # (K, N): out_proj / q, k, v and fc1's depth; fc2's


@pytest.fixture(scope="module")
def products():
    """For each XTRALARGE depth and M: x, W, and the float64 product."""
    out = {}
    gen = torch.Generator().manual_seed(3)
    for k, n in XL_DEPTHS:
        w = torch.randn(n, k, generator=gen) / math.sqrt(k)
        for m in (1, 64, 177, 425):
            x = torch.randn(m, k, generator=gen)
            out[(k, m)] = (x, w, x.double() @ w.double().T)
    return out


@pytest.mark.parametrize("m", [1, 64, 177, 425])
@pytest.mark.parametrize("k", [k for k, _ in XL_DEPTHS])
def test_plain_3xtf32_within_twice_fp32(products, k, m):
    x, w, ref = products[(k, m)]
    fp32 = rel(F.linear(x, w), ref)
    got = rel(g1.dense(x, g1.prepare(w)), ref)
    assert got <= 2 * fp32, (got, fp32)


@pytest.mark.parametrize("k", [k for k, _ in XL_DEPTHS])
def test_one_pass_tf32_fails_the_bound(products, k):
    x, w, ref = products[(k, 177)]
    fp32 = rel(F.linear(x, w), ref)
    one_pass = rel(F.linear(g1.tf32_round(x), g1.tf32_round(w)), ref)
    assert one_pass > 2 * fp32
    assert one_pass > 100 * fp32  # about 2^-11 per product against 2^-24


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_each_epilogue_matches_the_unfused_ops(epilogue):
    gen = torch.Generator().manual_seed(4)
    x, w, b = (torch.randn(37, 256, generator=gen), torch.randn(384, 256, generator=gen) / 16,
               torch.randn(384, generator=gen))
    r = torch.randn(37, 384, generator=gen)
    want = F.linear(x, w, b)
    want = F.gelu(want) if epilogue == "gelu" else r + want if epilogue == "residual" else want
    got = g1.dense(x, g1.prepare(w), b, epilogue, r if epilogue == "residual" else None)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_dense_refuses_what_it_does_not_take():
    w = g1.prepare(torch.randn(128, 64))
    x = torch.randn(3, 64)
    with pytest.raises(ValueError):
        g1.dense(x, w, None, "relu")
    with pytest.raises(ValueError):
        g1.dense(x, w, None, "residual")
    with pytest.raises(ValueError):
        g1.dense(x, w, None, "bias", torch.zeros(3, 128))
    with pytest.raises(ValueError):
        g1.dense(torch.randn(3, 32), w)
    with pytest.raises(ValueError):
        g1.dense(x, w, None, "residual", torch.zeros(4, 128))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_layer_matches_the_unfused_layer(masked):
    layer = randomized(EncoderLayer(LAYER), 5)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 23, 128, generator=gen)
    mask = (torch.arange(23)[None, :] < torch.tensor([[23], [17]])).float() if masked else None
    with torch.no_grad():
        assert not layer.on_g1(x)  # a CPU tensor keeps F.linear
        want = layer(x, mask)
        got = layer.forward_g1(x, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture
def on_card(monkeypatch):
    """The rule evaluated on CPU tensors as if they lay on a card, and every
    product that reaches the wrapper counted (`run`, which `dense` and the
    layers call; on the CPU it runs the plain version)."""
    calls = []
    real = g1.run

    def spy(*args, **kwargs):
        calls.append(args[1].n)
        return real(*args, **kwargs)

    monkeypatch.setattr(g1, "on_card", lambda x: True)
    monkeypatch.setattr(g1, "run", spy)
    return calls


def small_hubert(dtype=torch.float32, cfg: HubertConfig = LAYER) -> HubertModel:
    return randomized(HubertModel(cfg, dtype=dtype), 7, scale=0.1)


def test_hubert_routes_every_dense_layer(on_card):
    model = small_hubert()
    wav = torch.randn(2, 6480, generator=torch.Generator().manual_seed(8)) * 0.3
    with torch.no_grad():
        got = model(wav)
        assert on_card == [128] + [384, 128, 256, 128] * LAYER.num_layers  # 4 x layers + 1
        g1.on_card = lambda x: False
        want = model(wav)
    assert len(on_card) == 4 * LAYER.num_layers + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_rule_takes_only_the_fp32_no_grad_unsharded_case(on_card, monkeypatch):
    lin, x = Linear(128, 256), torch.randn(3, 128)
    with torch.no_grad():
        assert g1.engages(x, (lin,), True)
        assert not g1.engages(x, (lin,), False)  # widths G1 does not take
        assert not g1.engages(x.to(torch.bfloat16), (lin,), True)
        assert not g1.engages(x, (Linear(128, 256, dtype=torch.bfloat16),), True)
        lin.tp = object()  # a Shard under tensor parallelism
        assert not g1.engages(x, (lin,), True)
        lin.tp = None
    assert not g1.engages(x, (lin,), True)  # grad mode on, the weight requires grad
    lin.requires_grad_(False)
    assert g1.engages(x, (lin,), True)
    assert not g1.engages(x.requires_grad_(True), (lin,), True)
    monkeypatch.setattr(torch, "is_autocast_enabled", lambda *args: True)
    with torch.no_grad():
        assert not g1.engages(x, (lin,), True)


def test_bf16_never_reaches_the_wrapper(on_card):
    model = small_hubert(torch.bfloat16)
    with torch.no_grad():
        model(torch.randn(1, 3200))
    assert on_card == []


def test_autocast_never_reaches_the_wrapper(on_card, monkeypatch):
    monkeypatch.setattr(torch, "is_autocast_enabled", lambda *args: True)
    with torch.no_grad():
        small_hubert()(torch.randn(1, 3200))
    assert on_card == []


def test_a_backward_never_reaches_the_wrapper(on_card):
    model = small_hubert()
    model(torch.randn(1, 3200))  # grad mode on, the weights require grad
    assert on_card == []
    model.requires_grad_(False)
    model(torch.randn(1, 3200, requires_grad=True))  # the input does
    assert on_card == []
    model(torch.randn(1, 3200))  # nothing to differentiate
    assert len(on_card) == 4 * LAYER.num_layers + 1


def test_tensor_parallel_and_narrow_layers_never_reach_the_wrapper(on_card):
    layer = EncoderLayer(LAYER)
    x = torch.randn(1, 5, 128)
    with torch.no_grad():
        assert layer.on_g1(x)
        layer.fc1.tp = object()  # a Shard under tensor parallelism
        assert not layer.on_g1(x)
        narrow = HubertConfig(conv_layers=LAYER.conv_layers, hidden_size=32, num_layers=1,
                              num_heads=4, intermediate_size=64, pos_conv_kernel=8,
                              pos_conv_groups=4)
        assert not EncoderLayer(narrow).on_g1(torch.randn(1, 5, 32))
        small_hubert(cfg=narrow)(torch.randn(1, 3200))
    assert on_card == []


def test_a_cpu_tensor_never_reaches_the_wrapper(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper was called on the CPU path")

    monkeypatch.setattr(g1, "dense", refuse)
    monkeypatch.setattr(g1, "run", refuse)
    with torch.no_grad():
        small_hubert()(torch.randn(1, 3200))


def test_split_follows_load_state_dict_and_in_place_edits():
    layer = randomized(EncoderLayer(LAYER), 9)
    x = torch.randn(1, 19, 128, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        first = layer.forward_g1(x, None)
        layer.load_state_dict(randomized(EncoderLayer(LAYER), 11).state_dict())
        second = layer.forward_g1(x, None)
        torch.testing.assert_close(second, layer(x, None), atol=1e-5, rtol=1e-5)
        assert (second - first).abs().max() > 0.1
        layer.fc2.weight.mul_(0.5)
        third = layer.forward_g1(x, None)
        torch.testing.assert_close(third, layer(x, None), atol=1e-5, rtol=1e-5)
        assert (third - second).abs().max() > 1e-3


def pieces(m: int, n: int, k: int, grid: int):
    """The kernel's stream-K walk in Python: for each block, its pieces as
    (tile, kb0, kb1, slot), tile = column tile x row tiles + row tile, slot
    None for a whole tile; and for each tile in pieces the slots it is
    summed from, in k order (as its last block reads them)."""
    row_tiles, kbs = math.ceil(m / g1.BM), k // g1.BK
    total, groups = n // g1.BN * kbs, grid // row_tiles

    def start(g):
        return total * g // groups

    def group_of(pos):
        return ((pos + 1) * groups - 1) // total

    walk, order = [], {}
    for b in range(grid):
        g, mt = divmod(b, row_tiles)
        it, own = start(g), []
        while it < start(g + 1):
            nt, kb0 = divmod(it, kbs)
            kb1 = min(kbs, kb0 + start(g + 1) - it)
            slot = None if (kb0 == 0 and kb1 == kbs) else 2 * b + (0 if it == start(g) else 1)
            own.append((nt * row_tiles + mt, kb0, kb1, slot))
            it += kb1 - kb0
        walk.append(own)
    for nt in range(n // g1.BN):
        c0 = group_of(nt * kbs)
        n_pieces = group_of(nt * kbs + kbs - 1) - c0 + 1
        if n_pieces > 1:
            for mt in range(row_tiles):
                order[nt * row_tiles + mt] = [
                    2 * ((c0 + j) * row_tiles + mt) + (1 if j == 0 and start(c0) != nt * kbs else 0)
                    for j in range(n_pieces)]
    return walk, order


@pytest.mark.parametrize("m,n,k", [(1, 768, 768), (177, 3840, 1280), (177, 1280, 1280),
                                   (177, 5120, 1280), (177, 1280, 5120), (425, 1280, 5120),
                                   (500, 3072, 768), (8000, 768, 3072)])
def test_stream_k_walk_covers_each_k_block_once(m, n, k):
    kbs, row_tiles = k // g1.BK, math.ceil(m / g1.BM)
    tiles = row_tiles * (n // g1.BN)
    most = max(1, min(132 // row_tiles, n // g1.BN * kbs))
    for groups in sorted({1, 7, g1.plan(m, n, k, 132) // row_tiles, most}):
        grid = groups * row_tiles
        walk, order = pieces(m, n, k, grid)
        seen = np.zeros((tiles, kbs), dtype=np.int64)
        slots, by_tile = set(), {}
        for b, own in enumerate(walk):
            assert own, "every block has work"
            for t, kb0, kb1, slot in own:
                seen[t, kb0:kb1] += 1
                if slot is not None:
                    assert slot not in slots and slot // 2 == b
                    slots.add(slot)
                    by_tile.setdefault(t, []).append((kb0, slot))
        assert (seen == 1).all()
        assert set(order) == set(by_tile)
        for t, parts in by_tile.items():
            assert order[t] == [slot for _, slot in sorted(parts)]


def test_plan_fills_the_card_at_a_mean_request():
    for m in (177, 425):
        for n, k in ((3840, 1280), (1280, 1280), (5120, 1280), (1280, 5120)):
            grid = g1.plan(m, n, k, 132)
            assert 100 <= grid <= 132 and grid % math.ceil(m / g1.BM) == 0, (m, n, k, grid)
    assert g1.plan(1, 768, 768, 132) <= 132
    assert g1.plan(20000, 768, 768, 132) == math.ceil(20000 / g1.BM)  # one group, past 132
