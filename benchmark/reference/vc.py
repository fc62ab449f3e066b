"""The plain reference of the 48 kHz conversion generator's inference.

A frozen, self-contained restatement in plain PyTorch of what
`SynthesizerSVC.infer` computes (HuBERT content encoder with coarse-F0
conditioning, the residual-coupling flow in reverse, the HiFi-GAN MRF
decoder), written from the model's equations on raw weights: a dict of
tensors under the parameter names the program's state dict uses. Weight
norm is folded here, from `v` and `g`; nothing the program folded, cached
or drew is read. No kernel: every convolution and product is
`torch.nn.functional`, in float32, with TF32 off unless `tf32=True`, which
rounds the inputs of every product to TF32 (10 mantissa bits) and so
stands in for a TF32 tensor-core path (the control; `Ops`).

It imports nothing of the program or of JAX. `param_specs` lists every
parameter of the program's generator (the posterior encoder's too, which
inference does not read) with its shape and how the benchmark draws it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LRELU = 0.1
HUBERT_PAD = 40      # (receptive field - downsample) // 2 = (400 - 320) // 2
HUBERT_DOWNSAMPLE = 320
LENGTH_SCALE = (48000 / 512) / 16000   # output frames per 16 kHz source sample
FLOW_K, FLOW_LAYERS, N_FLOWS = 5, 4, 4
POST_K, POST_LAYERS = 5, 16
REL_WINDOW = 4
CONV_LAYERS = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 2, 2),
               (512, 2, 2))


@dataclass(frozen=True)
class Hubert:
    hidden: int
    layers: int
    heads: int
    ffn: int
    pos_k: int = 128
    pos_groups: int = 16
    conv_layers: Tuple[Tuple[int, int, int], ...] = CONV_LAYERS


HUBERT_BASE = Hubert(768, 12, 12, 3072)
HUBERT_XTRALARGE = Hubert(1280, 48, 16, 5120)


def hubert_for(model: dict, override: Optional[dict] = None) -> Hubert:
    """The HuBERT of a config: base at 768 channels, XTRALARGE at 1280, or
    an explicit override (tests)."""
    if override:
        o = dict(override)
        o["conv_layers"] = tuple(tuple(c) for c in o.get("conv_layers", CONV_LAYERS))
        return Hubert(**o)
    return HUBERT_XTRALARGE if model["hubert_channels"] == 1280 else HUBERT_BASE


# ------------------------------------------------------------------ specs
# kinds: ("k", std) a kernel N(0, std); "g" a weight-norm gain (||v||
# times 1 + N(0, 0.02), drawn after its v); "b" a bias N(0, 0.02); "ln" a
# norm's scale, 1 + N(0, 0.02); ("e", std) an embedding table.

def _conv(specs, name, shape, wn=False, bias=True, std=None):
    fan_in = math.prod(shape[1:])
    std = std if std is not None else 1.0 / math.sqrt(fan_in)
    if wn:
        specs.append((f"{name}.v", shape, ("k", std)))
        specs.append((f"{name}.g", (shape[0],) + (1,) * (len(shape) - 1), "g"))
    else:
        specs.append((f"{name}.weight", shape, ("k", std)))
    if bias:
        out = shape[1] if name.split(".")[-1].startswith("up_") else shape[0]
        specs.append((f"{name}.bias", (out,), "b"))


def _linear(specs, name, n_in, n_out, std=None):
    specs.append((f"{name}.weight", (n_out, n_in), ("k", std or 1.0 / math.sqrt(n_in))))
    specs.append((f"{name}.bias", (n_out,), "b"))


def _ln(specs, name, c):
    specs.append((f"{name}.weight", (c,), "ln"))
    specs.append((f"{name}.bias", (c,), "b"))


def _wn(specs, name, h, k, n_layers, gin):
    if gin > 0:
        _conv(specs, f"{name}.cond_layer", (2 * h * n_layers, gin, 1), wn=True)
    for i in range(n_layers):
        _conv(specs, f"{name}.in_{i}", (2 * h, h, k), wn=True)
        _conv(specs, f"{name}.res_skip_{i}", (2 * h if i < n_layers - 1 else h, h, 1), wn=True)


def param_specs(model: dict, data: dict, hub: Hubert) -> List[Tuple[str, tuple, object]]:
    """(name, shape, kind) of every generator parameter, in the program's
    names. `model` and `data` are the config's blocks."""
    m = model
    h, inter, gin, fc = m["hidden_channels"], m["inter_channels"], m["gin_channels"], \
        m["filter_channels"]
    s: list = []
    p = "enc_p.hubert"
    cin = 1
    for i, (dim, k, _) in enumerate(hub.conv_layers):
        _conv(s, f"{p}.feature_extractor.conv_{i}", (dim, cin, k), bias=False,
              std=math.sqrt(2.0 / (cin * k)))
        cin = dim
    _ln(s, f"{p}.feature_extractor.group_norm", hub.conv_layers[0][0])
    _ln(s, f"{p}.feat_ln", cin)
    _linear(s, f"{p}.post_extract_proj", cin, hub.hidden)
    _conv(s, f"{p}.pos_conv", (hub.hidden, hub.hidden // hub.pos_groups, hub.pos_k),
          std=math.sqrt(2.0 / (hub.hidden // hub.pos_groups * hub.pos_k)))
    _ln(s, f"{p}.encoder_ln", hub.hidden)
    for i in range(hub.layers):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(s, f"{p}.layer_{i}.attn.{n}", hub.hidden, hub.hidden)
        _ln(s, f"{p}.layer_{i}.ln1", hub.hidden)
        _linear(s, f"{p}.layer_{i}.fc1", hub.hidden, hub.ffn)
        _linear(s, f"{p}.layer_{i}.fc2", hub.ffn, hub.hidden)
        _ln(s, f"{p}.layer_{i}.ln2", hub.hidden)
    _linear(s, "enc_p.hubert_proj", hub.hidden, h)
    s.append(("enc_p.emb_pitch.weight", (m["num_pitch"], h), ("e", h ** -0.5)))
    d_k = h // m["n_heads"]
    for i in range(m["n_layers"]):
        a = f"enc_p.encoder.attn_{i}"
        for n in ("conv_q", "conv_k", "conv_v"):
            _linear(s, f"{a}.{n}", h, h, std=math.sqrt(2.0 / (2 * h)))
        _linear(s, f"{a}.conv_o", h, h)
        s.append((f"{a}.emb_rel_k", (1, 2 * REL_WINDOW + 1, d_k), ("e", d_k ** -0.5)))
        s.append((f"{a}.emb_rel_v", (1, 2 * REL_WINDOW + 1, d_k), ("e", d_k ** -0.5)))
        _ln(s, f"enc_p.encoder.norm1_{i}", h)
        _conv(s, f"enc_p.encoder.ffn_{i}.conv_1", (fc, h, m["kernel_size"]))
        _conv(s, f"enc_p.encoder.ffn_{i}.conv_2", (h, fc, m["kernel_size"]))
        _ln(s, f"enc_p.encoder.norm2_{i}", h)
    # the prior's and the posterior's (mean, log-scale) projections drawn at a
    # tenth of the usual scale: log-scales start near 0, as a trained model's
    # do, and the train step's KL term is of order one, not 1e5
    _conv(s, "enc_p.proj", (2 * inter, h, 1), std=0.1 / math.sqrt(h))
    # decoder
    c0 = m["upsample_initial_channel"]
    _conv(s, "dec.conv_pre", (c0, inter, 7), wn=True)
    if gin > 0:
        _linear(s, "dec.cond", gin, c0)
    ch = c0
    for i, (u, k) in enumerate(zip(m["upsample_rates"], m["upsample_kernel_sizes"])):
        co = c0 // (2 ** (i + 1))
        _conv(s, f"dec.up_{i}", (ch, co, k), wn=True, std=1.0 / math.sqrt(ch * k / u))
        for j, (rk, rd) in enumerate(zip(m["resblock_kernel_sizes"],
                                         m["resblock_dilation_sizes"])):
            for t in range(len(rd)):
                _conv(s, f"dec.res_{i}_{j}.c1_{t}", (co, co, rk), wn=True)
                _conv(s, f"dec.res_{i}_{j}.c2_{t}", (co, co, rk), wn=True)
        ch = co
    _conv(s, "dec.conv_post", (1, ch, 7), wn=True)
    # flow
    half = inter // 2
    for i in range(N_FLOWS):
        f = f"flow.flow_{i}"
        _conv(s, f"{f}.pre", (h, half, 1))
        _wn(s, f"{f}.enc", h, FLOW_K, FLOW_LAYERS, gin)
        _conv(s, f"{f}.post", (half, h, 1))
    if data["n_speakers"] >= 1:
        s.append(("emb_g.weight", (data["n_speakers"], gin), ("e", 1.0)))
    # posterior encoder (training only; drawn so the state dict is whole)
    _conv(s, "enc_q.pre", (h, data["filter_length"] // 2 + 1, 1))
    _wn(s, "enc_q.enc", h, POST_K, POST_LAYERS, gin)
    _conv(s, "enc_q.proj", (2 * inter, h, 1), std=0.1 / math.sqrt(h))
    return s


# ------------------------------------------------------------- arithmetic
def _fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(x.abs().amax().float(), 1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _fp8_e5m2(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(x.abs().amax().float(), 1e-30) / 57344.0
    return (x / scale).to(torch.float8_e5m2).float() * scale


def _tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


# precision -> (how a product's inputs are rounded, how the gradient of its
# output is rounded before the backward's products read it)
_ROUNDING = {"tf32": (_tf32, None), "fp8": (_fp8_e4m3, _fp8_e5m2)}


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the backward rounds the incoming gradient."""

    @staticmethod
    def forward(ctx, x, rounding):
        ctx.rounding = rounding
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rounding(g), None


class Ops:
    """Products and convolutions in float32. A lower `precision` computes
    them as a product in that precision does, from rounded operands with a
    float32 sum: "tf32" rounds the inputs to TF32 (round to nearest even on
    10 mantissa bits); "fp8" rounds them to float8 e4m3 and, in training,
    the gradient of the output to e5m2 before the backward's products, each
    under a per-tensor scale that maps its largest magnitude to the format's
    largest. The gradient passes through the rounding of the inputs as if it were not
    there. Those are the controls: the reference in the program's place one
    precision below the configuration's."""

    def __init__(self, precision: Optional[str] = None):
        if precision not in (None, *_ROUNDING):
            raise ValueError(f"unknown precision {precision!r}")
        self.fwd, self.bwd = _ROUNDING.get(precision, (None, None))

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.fwd is None:
            return x
        with torch.no_grad():
            q = self.fwd(x)
        return x + (q - x).detach() if x.requires_grad else q

    def g(self, y: torch.Tensor) -> torch.Tensor:
        """y, whose gradient is rounded on its way into the product that
        made it."""
        if self.bwd is None or not y.requires_grad:
            return y
        return _RoundGrad.apply(y, self.bwd)

    def mm(self, a, b):
        return self.g(torch.matmul(self.r(a), self.r(b)))

    def linear(self, x, w, b):
        return self.g(F.linear(self.r(x), self.r(w), b))

    def conv1d(self, x, w, b, pad=(0, 0), stride=1, dilation=1, groups=1):
        """x [B, T, C] -> [B, T', C'] (PyTorch conv1d semantics)."""
        xt = F.pad(x.transpose(1, 2), pad) if pad != (0, 0) else x.transpose(1, 2)
        y = F.conv1d(self.r(xt), self.r(w), b, stride=stride, dilation=dilation, groups=groups)
        return self.g(y).transpose(1, 2)

    def conv_transpose1d(self, x, w, b, stride, padding):
        y = F.conv_transpose1d(self.r(x.transpose(1, 2)), self.r(w), b, stride=stride,
                               padding=padding)
        return self.g(y).transpose(1, 2)


def wn_fold(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight norm over every axis but the first: g * v / ||v||."""
    dims = tuple(range(1, v.ndim))
    return g * v / torch.clamp_min(torch.sqrt(torch.sum(v.float() ** 2, dim=dims,
                                                        keepdim=True)), 1e-12)


def kernel(w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return wn_fold(w[f"{name}.v"], w[f"{name}.g"]) if f"{name}.v" in w else w[f"{name}.weight"]


def layer_norm(w, name, x, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], eps)


def sequence_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    pos = torch.arange(t, device=lengths.device)
    return (pos[None, :] < lengths[:, None].to(torch.int64)).float()[:, :, None]


def nearest_interp(x: torch.Tensor, t_out: int) -> torch.Tensor:
    idx = torch.arange(t_out, device=x.device) * x.shape[1] // t_out
    return x[:, idx, :]


# ------------------------------------------------------------------ HuBERT
def hubert(w, ops: Ops, hub: Hubert, wav: torch.Tensor) -> torch.Tensor:
    """[B, T] 16 kHz -> [B, frames, hidden]: the conv front end (GroupNorm
    per channel on conv 0, exact GELU), feat_ln, the projection, the
    grouped positional conv (last frame dropped), encoder_ln, then
    post-LN transformer layers with no mask."""
    p = "enc_p.hubert"
    x = wav[:, :, None]
    for i, (_, _, stride) in enumerate(hub.conv_layers):
        x = ops.conv1d(x, w[f"{p}.feature_extractor.conv_{i}.weight"], None, stride=stride)
        if i == 0:
            mean = x.mean(dim=1, keepdim=True)
            var = x.var(dim=1, keepdim=True, unbiased=False)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
            x = x * w[f"{p}.feature_extractor.group_norm.weight"] \
                + w[f"{p}.feature_extractor.group_norm.bias"]
        x = F.gelu(x)
    x = layer_norm(w, f"{p}.feat_ln", x)
    x = ops.linear(x, w[f"{p}.post_extract_proj.weight"], w[f"{p}.post_extract_proj.bias"])
    k = hub.pos_k
    pos = ops.conv1d(x, w[f"{p}.pos_conv.weight"], w[f"{p}.pos_conv.bias"], pad=(k // 2, k // 2),
                     groups=hub.pos_groups)
    if k % 2 == 0:
        pos = pos[:, :-1]
    x = layer_norm(w, f"{p}.encoder_ln", x + F.gelu(pos))
    b, t, c = x.shape
    d = c // hub.heads
    for i in range(hub.layers):
        q_ = f"{p}.layer_{i}"

        def lin(n, y):
            return ops.linear(y, w[f"{q_}.{n}.weight"], w[f"{q_}.{n}.bias"])

        def heads(y):
            return y.reshape(b, t, hub.heads, d).transpose(1, 2)

        q = heads(lin("attn.q_proj", x))
        kk = heads(lin("attn.k_proj", x))
        v = heads(lin("attn.v_proj", x))
        scores = ops.mm(q / d ** 0.5, kk.transpose(-1, -2))
        a = ops.mm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, c)
        x = layer_norm(w, f"{q_}.ln1", x + lin("attn.out_proj", a))
        x = layer_norm(w, f"{q_}.ln2", x + lin("fc2", F.gelu(lin("fc1", x))))
    return x


# ------------------------------------------------------- content encoder
def _rel_to_abs(x):
    b, h, n, _ = x.shape
    x = F.pad(x, (0, 1))
    x = F.pad(x.reshape(b, h, n * 2 * n), (0, n - 1))
    return x.reshape(b, h, n + 1, 2 * n - 1)[:, :, :n, n - 1:]


def _abs_to_rel(x):
    b, h, n, _ = x.shape
    x = F.pad(x, (0, n - 1))
    x = F.pad(x.reshape(b, h, n * n + n * (n - 1)), (n, 0))
    return x.reshape(b, h, n, 2 * n)[:, :, :, 1:]


def _rel_emb(emb, n):
    pad = max(n - (REL_WINDOW + 1), 0)
    start = max((REL_WINDOW + 1) - n, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * n - 1]


def prior_encoder(w, ops: Ops, model: dict, x: torch.Tensor, x_mask: torch.Tensor,
                  drop=None):
    """The relative-position transformer (window 4, heads sharing the
    relative embeddings, -1e4 mask fill, post-LN, conv FFN with ReLU).
    `drop` (training) is applied where the model drops out, in its order:
    the attention weights, the attention's output, the FFN's activation,
    the FFN's output."""
    drop = drop or (lambda t: t)
    heads = model["n_heads"]
    ks = model["kernel_size"]
    m = x_mask[..., 0]
    attn_mask = m[:, None, :, None] * m[:, None, None, :]
    x = x * x_mask
    b, t, c = x.shape
    d = c // heads
    for i in range(model["n_layers"]):
        a = f"enc_p.encoder.attn_{i}"

        def lin(n, y):
            return ops.linear(y, w[f"{a}.{n}.weight"], w[f"{a}.{n}.bias"])

        def split(y):
            return y.reshape(b, t, heads, d).transpose(1, 2)

        q = split(lin("conv_q", x)) * (1.0 / math.sqrt(d))
        k, v = split(lin("conv_k", x)), split(lin("conv_v", x))
        scores = ops.mm(q, k.transpose(-1, -2))
        scores = scores + _rel_to_abs(ops.mm(q, _rel_emb(w[f"{a}.emb_rel_k"], t)
                                             .transpose(-1, -2)))
        p_attn = drop(torch.softmax(scores.masked_fill(attn_mask == 0, -1e4), dim=-1))
        out = ops.mm(p_attn, v) + ops.mm(_abs_to_rel(p_attn), _rel_emb(w[f"{a}.emb_rel_v"], t))
        y = lin("conv_o", out.transpose(1, 2).reshape(b, t, c))
        x = layer_norm(w, f"enc_p.encoder.norm1_{i}", x + drop(y))
        f = f"enc_p.encoder.ffn_{i}"
        pad = ((ks - 1) // 2, ks // 2)
        y = ops.conv1d(x * x_mask, w[f"{f}.conv_1.weight"], w[f"{f}.conv_1.bias"], pad=pad)
        y = ops.conv1d(drop(torch.relu(y)) * x_mask, w[f"{f}.conv_2.weight"],
                       w[f"{f}.conv_2.bias"], pad=pad) * x_mask
        x = layer_norm(w, f"enc_p.encoder.norm2_{i}", x + drop(y))
    return x * x_mask


def content_encoder(w, ops: Ops, model: dict, hub: Hubert, wav, wav_len, pitch):
    """-> (m_p, logs_p) on the 50 Hz frame axis."""
    feats = hubert(w, ops, hub, F.pad(wav, (HUBERT_PAD, HUBERT_PAD)))
    return prior(w, ops, model, feats, wav_len, pitch)


def prior(w, ops: Ops, model: dict, feats, wav_len, pitch, drop=None):
    """HuBERT features -> (m_p, logs_p): the projection, the pitch
    embedding, the transformer, `proj`."""
    h = ops.linear(feats, w["enc_p.hubert_proj.weight"], w["enc_p.hubert_proj.bias"])
    t50 = h.shape[1]
    idx = torch.clamp(pitch[:, :t50], 0, model["num_pitch"] - 1)
    h = h + w["enc_p.emb_pitch.weight"][idx]
    x_mask = sequence_mask(wav_len.to(torch.int64) // HUBERT_DOWNSAMPLE, t50)
    x = prior_encoder(w, ops, model, h * x_mask, x_mask, drop)
    stats = ops.conv1d(x, w["enc_p.proj.weight"], w["enc_p.proj.bias"]) * x_mask
    inter = model["inter_channels"]
    return stats[..., :inter], stats[..., inter:]


# -------------------------------------------------------------------- flow
def wavenet(w, ops: Ops, name: str, x, x_mask, g, n_layers, k):
    """Gated dilated conv stack (dilation 1) with the speaker term; the
    last layer's res_skip is skip only."""
    h = x.shape[-1]
    out = torch.zeros_like(x)
    cond = None
    if g is not None and f"{name}.cond_layer.v" in w:
        cond = ops.linear(g, kernel(w, f"{name}.cond_layer")[:, :, 0],
                          w[f"{name}.cond_layer.bias"])
    for i in range(n_layers):
        a = ops.conv1d(x, kernel(w, f"{name}.in_{i}"), w[f"{name}.in_{i}.bias"],
                       pad=((k - 1) // 2, (k - 1) // 2))
        if cond is not None:
            a = a + cond[:, None, i * 2 * h:(i + 1) * 2 * h]
        acts = torch.tanh(a[..., :h]) * torch.sigmoid(a[..., h:])
        rs = ops.conv1d(acts, kernel(w, f"{name}.res_skip_{i}"), w[f"{name}.res_skip_{i}.bias"])
        if i < n_layers - 1:
            x = (x + rs[..., :h]) * x_mask
            out = out + rs[..., h:]
        else:
            out = out + rs
    return out * x_mask


def flow_reverse(w, ops: Ops, z, mask, g):
    """The couplings in reverse order, each after a channel flip:
    x1 -= post(WN(pre(x0)))."""
    half = z.shape[-1] // 2
    for i in reversed(range(N_FLOWS)):
        f = f"flow.flow_{i}"
        z = torch.flip(z, dims=[-1])
        x0, x1 = z[..., :half], z[..., half:]
        h = ops.conv1d(x0, w[f"{f}.pre.weight"], w[f"{f}.pre.bias"]) * mask
        h = wavenet(w, ops, f"{f}.enc", h, mask, g, FLOW_LAYERS, FLOW_K)
        stats = ops.conv1d(h, w[f"{f}.post.weight"], w[f"{f}.post.bias"]) * mask
        z = torch.cat([x0, (x1 - stats) * mask], dim=-1)
    return z


# ----------------------------------------------------------------- decoder
def decoder(w, ops: Ops, model: dict, z, g):
    """conv_pre, the speaker term, per stage lrelu -> transposed conv ->
    the mean of the ResBlock1 blocks; lrelu(0.01), conv_post, tanh."""
    x = ops.conv1d(z, kernel(w, "dec.conv_pre"), w["dec.conv_pre.bias"], pad=(3, 3))
    if g is not None and "dec.cond.weight" in w:
        x = x + ops.linear(g, w["dec.cond.weight"], w["dec.cond.bias"])[:, None, :]
    kss, dss = model["resblock_kernel_sizes"], model["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(model["upsample_rates"], model["upsample_kernel_sizes"])):
        x = ops.conv_transpose1d(F.leaky_relu(x, LRELU), kernel(w, f"dec.up_{i}"),
                                 w[f"dec.up_{i}.bias"], u, (k - u) // 2)
        total = None
        for j, (rk, rd) in enumerate(zip(kss, dss)):
            h = x
            for t, d in enumerate(rd):
                c = f"dec.res_{i}_{j}"
                pad = (rk * d - d) // 2
                y = ops.conv1d(F.leaky_relu(h, LRELU), kernel(w, f"{c}.c1_{t}"),
                               w[f"{c}.c1_{t}.bias"], pad=(pad, pad), dilation=d)
                p2 = (rk - 1) // 2
                h = h + ops.conv1d(F.leaky_relu(y, LRELU), kernel(w, f"{c}.c2_{t}"),
                                   w[f"{c}.c2_{t}.bias"], pad=(p2, p2))
            total = h if total is None else total + h
        x = total / float(len(kss))
    x = ops.conv1d(F.leaky_relu(x, 0.01), kernel(w, "dec.conv_post"), w["dec.conv_post.bias"],
                   pad=(3, 3))
    return torch.tanh(x)


# ------------------------------------------------------------------- infer
@torch.no_grad()
def infer(w, model: dict, hub: Hubert, wav, wav_len, pitch, sid, eps, noise_scale=1.0,
          tf32: bool = False):
    """One batch, as `SynthesizerSVC.infer`: wav [B, T] (padded), wav_len
    [B], pitch [B, T // 320], sid [B], eps [B, t_out, inter] (the draw the
    program made from its seed, drawn again by the caller) -> (o [B,
    t_out * hop], output frames [B])."""
    ops = Ops("tf32" if tf32 else None)
    m_p, logs_p = content_encoder(w, ops, model, hub, wav, wav_len, pitch)
    g = w["emb_g.weight"][sid] if "emb_g.weight" in w else None
    t_out = int(round(wav.shape[1] * LENGTH_SCALE))
    y_len = (wav_len.to(torch.float32) * LENGTH_SCALE).to(torch.int32)
    y_mask = sequence_mask(y_len, t_out)
    m_p, logs_p = nearest_interp(m_p, t_out), nearest_interp(logs_p, t_out)
    z_p = m_p + eps * torch.exp(logs_p) * noise_scale
    z = flow_reverse(w, ops, z_p, y_mask, g) * y_mask
    return decoder(w, ops, model, z, g)[..., 0], y_len
