"""The plain reference of VITS's train step (the TTS model's GAN step).

What `TTSTrainStep.__call__` computes on VITS's configuration
(github.com/jaywalnut310/vits configs/vctk_base.json, with the keys
benchmark/configs/vits_vctk.json adds: the multi-period discriminator
alone, no pitch or energy heads), restated in plain float32 PyTorch with
autograd on raw weights under the program's parameter names
(`param_specs`, `disc_specs`). It reuses benchmark/reference/train.py's
posterior, flow, decoder, discriminator heads, losses, signal code and
AdamW, and vc.py's relative-position transformer, and adds:

1. the text encoder: the symbol embedding x sqrt(hidden), the relative
   transformer (window 4), the 1x1 projection to (m_p, logs_p);
2. `neg_cent`, the log-likelihood of each frame of z_p under each text
   position's Gaussian, with no gradient;
3. MAS (`maximum_path`) as a plain dynamic programme over the frames,
   vectorised over the rows and the text positions, from its own
   neg_cent: at a tie the path stays on its text position;
4. the stochastic duration predictor's training direction (`sdp_nll`):
   the posterior flows over the injected noise, the rational-quadratic
   spline couplings (`rq_spline`, linear tails at +-5, 10 bins), the log
   flow, the prior flows, NLL + log q;
5. the duration loss sum(nll) / sum(x_mask), and the step
   total = p_gen + p_fm + c_mel * mel-L1 + c_kl * KL + dur.

Departures from VITS's train_ms.py, all the program's:

* bf16 in place of fp16 with a GradScaler is the program's half precision;
  this reference is float32 with TF32 off (the caller sets it);
* MAS runs on the card (kernel M1) in the program, and in Cython on the
  host in VITS; both are the same DP, ties kept;
* the generator updates first, on the discriminator's weights before its
  update, and the discriminator then updates on that step's generated
  segment, detached (VITS updates the discriminator first and scores the
  generator with the updated one);
* AdamW's weight decay is 0.01 (torch.optim.AdamW's default, which VITS
  also uses);
* the posterior noise, the duration predictor's noise and the segment
  starts are injected, and the dropout masks are drawn as the program
  draws them (`rand(shape) >= rate` from a generator seeded with the
  step's seed + 1, in the program's order: the text encoder's, then the
  duration predictor's), not from torch's global generator;
* the target spectrogram and log-mel come from a float64 DFT, as
  train.py's.

Imports nothing of the program or of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import train as rt
from benchmark.reference import vc as ref
from benchmark.reference.vc import Ops

SDP_K, SDP_LAYERS, SDP_FLOWS, SDP_DROPOUT = 3, 3, 4, 0.5
BINS, TAIL = 10, 5.0
MIN_BIN, MIN_DERIV = 1e-3, 1e-3
NEG = -1e9
C_DUR = 1.0


# ------------------------------------------------------------------ specs
def _dds_specs(s, name: str, c: int) -> None:
    for i in range(SDP_LAYERS):
        ref._conv(s, f"{name}.sep_{i}", (c, 1, SDP_K))
        ref._ln(s, f"{name}.norm1_{i}", c)
        ref._conv(s, f"{name}.pw_{i}", (c, c, 1))
        ref._ln(s, f"{name}.norm2_{i}", c)


def _conv_flow_specs(s, name: str, c: int) -> None:
    ref._conv(s, f"{name}.pre", (c, 1, 1))
    _dds_specs(s, f"{name}.convs", c)
    # the spline's knots drawn at a tenth of the usual scale, near the
    # identity that VITS's zero-initialised projection starts from: at the
    # full scale the splines' bins are steep, and a 1e-3 change of the text
    # encoding moves the duration predictor's gradients by 10 %
    ref._conv(s, f"{name}.proj", (3 * BINS - 1, c, 1), std=0.1 / math.sqrt(c))


def param_specs(model: dict, data: dict) -> List[tuple]:
    """(name, shape, kind) of every parameter of the program's TTS
    generator on VITS's configuration: the text encoder, the conversion
    model's decoder, flow, posterior and speaker table (vc.py's specs
    without the content encoder's HuBERT and pitch), and the stochastic
    duration predictor."""
    h, gin = model["hidden_channels"], model["gin_channels"]
    s: list = [("enc_p.emb.weight", (model["n_vocab"], h), ("e", h ** -0.5))]
    no_hubert = ref.Hubert(8, 0, 1, 8, pos_k=2, pos_groups=1, conv_layers=((8, 10, 5),))
    vc_model = dict(model, num_pitch=1, hubert_channels=8)
    s += [spec for spec in ref.param_specs(vc_model, data, no_hubert)
          if not spec[0].startswith(("enc_p.hubert", "enc_p.emb_pitch"))]
    p = "duration_predictor"
    s += [(f"{p}.pre_affine.m", (2,), "b"), (f"{p}.pre_affine.logs", (2,), "b")]
    for i in range(SDP_FLOWS):
        _conv_flow_specs(s, f"{p}.flow_{i}", h)
    ref._conv(s, f"{p}.post_pre", (h, 1, 1))
    ref._conv(s, f"{p}.post_proj", (h, h, 1))
    _dds_specs(s, f"{p}.post_convs", h)
    s += [(f"{p}.post_affine.m", (2,), "b"), (f"{p}.post_affine.logs", (2,), "b")]
    for i in range(4):
        _conv_flow_specs(s, f"{p}.post_flow_{i}", h)
    ref._conv(s, f"{p}.pre", (h, h, 1))
    ref._conv(s, f"{p}.proj", (h, h, 1))
    _dds_specs(s, f"{p}.convs", h)
    if gin > 0:
        ref._conv(s, f"{p}.cond", (h, gin, 1))
    return s


def disc_specs(model: dict) -> List[tuple]:
    """The multi-period discriminator's parameters (one scale head, a head
    a period), train.py's names."""
    return [spec for spec in rt.disc_specs(model) if not spec[0].startswith("msd.")]


def target_data(data: dict) -> dict:
    """The data block with VITS's one `sampling_rate` as the target rate."""
    return dict(data, target_sampling_rate=data.get("target_sampling_rate",
                                                    data.get("sampling_rate")))


# ------------------------------------------------------------ text encoder
def text_encoder(w, ops: Ops, model: dict, x, x_lengths, drop=None):
    """ids [B, T_x] -> (h, m_p, logs_p, x_mask), all [B, T_x, *]."""
    h = model["hidden_channels"]
    e = w["enc_p.emb.weight"][torch.clamp(x, 0, model["n_vocab"] - 1)] * math.sqrt(h)
    x_mask = ref.sequence_mask(x_lengths, x.shape[1])
    enc = ref.prior_encoder(w, ops, model, e, x_mask, drop)
    stats = ops.conv1d(enc, w["enc_p.proj.weight"], w["enc_p.proj.bias"]) * x_mask
    inter = model["inter_channels"]
    return enc, stats[..., :inter], stats[..., inter:], x_mask


# --------------------------------------------------------------- alignment
@torch.no_grad()
def neg_cent(ops: Ops, z_p, m_p, logs_p):
    """[B, T_y, T_x]: log N(z_p[y] | m_p[x], exp(logs_p[x])) summed over
    channels."""
    s = torch.exp(-2.0 * logs_p)
    c1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=-1)
    c2 = ops.mm(-0.5 * z_p ** 2, s.transpose(1, 2))
    c3 = ops.mm(z_p, (m_p * s).transpose(1, 2))
    c4 = torch.sum(-0.5 * m_p ** 2 * s, dim=-1)
    return c1[:, None, :] + c2 + c3 + c4[:, None, :]


@torch.no_grad()
def maximum_path(score, x_lengths, y_lengths):
    """score [B, T_y, T_x] -> the monotonic path [B, T_x, T_y] (0/1,
    float32) that maximises the summed score of the cells it visits from
    (0, 0) to (x_len - 1, y_len - 1), one text position a frame, stepping
    by 0 or 1: VITS's monotonic_align as a DP over the frames. best[x] is
    the best sum of a path ending at x on the frame; it moves on from x - 1
    only where that is strictly better. Outside the lengths the scores
    are -1e9 and the path is 0. On the meta device, where only shapes
    flow, the path's shape."""
    b, t_y, t_x = score.shape
    dev = score.device
    if dev.type == "meta":
        return torch.empty((b, t_x, t_y), device=dev)
    xs = torch.arange(t_x, device=dev)
    ys = torch.arange(t_y, device=dev)
    inside = (xs[None, None, :] < x_lengths.long()[:, None, None]) \
        & (ys[None, :, None] < y_lengths.long()[:, None, None])
    v = torch.where(inside, score.float(), torch.full((), NEG, device=dev))
    neg = torch.full((b, 1), NEG, device=dev)
    best = torch.cat([v[:, 0, :1], neg.expand(b, t_x - 1)], dim=1)
    moved = torch.zeros(t_y, b, t_x, dtype=torch.bool, device=dev)
    for y in range(1, t_y):
        from_below = torch.cat([neg, best[:, :-1]], dim=1)
        moved[y] = from_below > best
        best = torch.maximum(from_below, best) + v[:, y, :]
    rows = torch.arange(b, device=dev)
    x = torch.clamp_min(x_lengths.long(), 1) - 1
    last = torch.clamp_min(y_lengths.long(), 1) - 1
    at = torch.zeros(b, t_y, dtype=torch.long, device=dev)
    for y in range(t_y - 1, -1, -1):
        at[:, y] = x
        step = moved[y, rows, torch.clamp_min(x, 0)] & (y <= last) & (y > 0)
        x = x - step.long()
    path = (xs[None, :, None] == at[:, None, :]).float()
    return path * inside.transpose(1, 2).float()


# ---------------------------------------------------------- duration model
def _dds_forward(w, ops: Ops, name: str, x, mask, g=None, drop=None):
    """The dilated depth-separable conv stack (dilation 3^i, exact GELU)."""
    if g is not None:
        x = x + g
    c = x.shape[-1]
    for i in range(SDP_LAYERS):
        d = SDP_K ** i
        pad = (SDP_K * d - d) // 2
        y = ops.conv1d(x * mask, w[f"{name}.sep_{i}.weight"], w[f"{name}.sep_{i}.bias"],
                       pad=(pad, pad), dilation=d, groups=c)
        y = F.gelu(ref.layer_norm(w, f"{name}.norm1_{i}", y))
        y = ops.conv1d(y, w[f"{name}.pw_{i}.weight"], w[f"{name}.pw_{i}.bias"])
        y = F.gelu(ref.layer_norm(w, f"{name}.norm2_{i}", y))
        x = x + (drop(y) if drop is not None else y)
    return x * mask


def _knots(un, lo: float, hi: float, min_bin: float):
    """(bin sizes, edges [..., K+1]) of a spline axis from unnormalised
    sizes: softmax above a floor, the outer edges pinned to lo and hi."""
    k = un.shape[-1]
    sizes = min_bin + (1.0 - min_bin * k) * torch.softmax(un, dim=-1)
    edges = lo + (hi - lo) * F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    edges = torch.cat([torch.full_like(edges[..., :1], lo), edges[..., 1:-1],
                       torch.full_like(edges[..., :1], hi)], dim=-1)
    return edges[..., 1:] - edges[..., :-1], edges


def rq_spline(x, uw, uh, ud):
    """The monotone rational-quadratic spline (Durkan et al., 2019) on
    [-TAIL, TAIL] with the identity outside, forward: (y, log|dy/dx|).
    x [...], uw and uh [..., K], ud [..., K-1] (the inner knots'
    derivatives; the outer ones are 1)."""
    inside = (x >= -TAIL) & (x <= TAIL)
    one = math.log(math.expm1(1.0 - MIN_DERIV))
    ud = F.pad(ud, (1, 1), value=float(np.float32(one)))
    widths, xk = _knots(uw, -TAIL, TAIL, MIN_BIN)
    heights, yk = _knots(uh, -TAIL, TAIL, MIN_BIN)
    deriv = MIN_DERIV + F.softplus(ud)
    xc = torch.clamp(x, -TAIL, TAIL)
    right = torch.cat([xk[..., :-1], xk[..., -1:] + 1e-6], dim=-1)
    k = torch.clamp(torch.sum(xc[..., None] >= right, dim=-1) - 1, 0, uw.shape[-1] - 1)[..., None]

    def at(t):
        return torch.gather(t, -1, k)[..., 0]

    w_k, x0, h_k, y0 = at(widths), at(xk[..., :-1]), at(heights), at(yk[..., :-1])
    s_k = at(heights / widths)
    d0, d1 = at(deriv[..., :-1]), at(deriv[..., 1:])
    t = (xc - x0) / w_k
    tt = t * (1 - t)
    den = s_k + (d0 + d1 - 2 * s_k) * tt
    y = y0 + h_k * (s_k * t ** 2 + d0 * tt) / den
    lad = torch.log(s_k ** 2 * (d1 * t ** 2 + 2 * s_k * tt + d0 * (1 - t) ** 2)) \
        - 2 * torch.log(den)
    return torch.where(inside, y, x), torch.where(inside, lad, torch.zeros_like(lad))


def _conv_flow(w, ops: Ops, name: str, x, mask, g):
    """The spline coupling: x1 through the spline whose knots a DDSConv
    reads from x0 (and g); -> (x, log|det| [B])."""
    x0, x1 = x[..., :1], x[..., 1:]
    fc = w[f"{name}.pre.weight"].shape[0]
    h = ops.conv1d(x0, w[f"{name}.pre.weight"], w[f"{name}.pre.bias"])
    h = _dds_forward(w, ops, f"{name}.convs", h, mask, g)
    h = ops.conv1d(h, w[f"{name}.proj.weight"], w[f"{name}.proj.bias"]) * mask
    h = h.reshape(*x1.shape, -1)  # [B, T, 1, 3K - 1]
    scale = 1.0 / math.sqrt(fc)
    y1, lad = rq_spline(x1, h[..., :BINS] * scale, h[..., BINS:2 * BINS] * scale,
                        h[..., 2 * BINS:])
    return torch.cat([x0, y1], dim=-1) * mask, torch.sum(lad * mask, dim=(1, 2))


def _affine(w, name: str, x, mask):
    logs = w[f"{name}.logs"]
    return (w[f"{name}.m"] + torch.exp(logs) * x) * mask, torch.sum(logs * mask, dim=(1, 2))


def sdp_nll(w, ops: Ops, h, x_mask, dur, g, e_q, drop=None):
    """The stochastic duration predictor's training direction: each row's
    -log p(durations) bound [B] for the durations dur [B, T_x, 1], from
    the detached text encoding h, the detached speaker g and the injected
    noise e_q [B, T_x, 2]."""
    p = "duration_predictor"
    x = ops.conv1d(h.detach(), w[f"{p}.pre.weight"], w[f"{p}.pre.bias"])
    if g is not None:
        x = x + ops.linear(g.detach(), w[f"{p}.cond.weight"][:, :, 0],
                           w[f"{p}.cond.bias"])[:, None, :]
    x = _dds_forward(w, ops, f"{p}.convs", x, x_mask, drop=drop)
    x = ops.conv1d(x, w[f"{p}.proj.weight"], w[f"{p}.proj.bias"]) * x_mask
    hw = ops.conv1d(dur, w[f"{p}.post_pre.weight"], w[f"{p}.post_pre.bias"])
    hw = _dds_forward(w, ops, f"{p}.post_convs", hw, x_mask)
    hw = ops.conv1d(hw, w[f"{p}.post_proj.weight"], w[f"{p}.post_proj.bias"]) * x_mask
    e_q = e_q * x_mask
    z, logdet_q = _affine(w, f"{p}.post_affine", e_q, x_mask)
    for i in range(4):
        z, ld = _conv_flow(w, ops, f"{p}.post_flow_{i}", z, x_mask, x + hw)
        logdet_q = logdet_q + ld
        z = torch.flip(z, dims=[-1])
    z_u, z1 = z[..., :1], z[..., 1:]
    u = torch.sigmoid(z_u) * x_mask
    z0 = (dur - u) * x_mask
    logdet_q = logdet_q + torch.sum((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
    logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask, dim=(1, 2)) - logdet_q
    z0 = torch.log(torch.clamp_min(z0, 1e-5)) * x_mask
    logdet = torch.sum(-z0, dim=(1, 2))
    z, ld = _affine(w, f"{p}.pre_affine", torch.cat([z0, z1], dim=-1), x_mask)
    logdet = logdet + ld
    for i in range(SDP_FLOWS):
        z, ld = _conv_flow(w, ops, f"{p}.flow_{i}", z, x_mask, x)
        logdet = logdet + ld
        z = torch.flip(z, dims=[-1])
    nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask, dim=(1, 2)) - logdet
    return nll + logq


# -------------------------------------------------------------- generator
def generator(w, ops: Ops, cfg: dict, batch, spec, draw, drop=None, drop_sdp=None):
    """The training forward -> (o [B, segment, 1], l_length [B], attn
    [B, T_x, T_y], z_p, m_p, logs_p (expanded to the frames), logs_q,
    y_mask)."""
    model, data = cfg["model"], target_data(cfg["data"])
    h, m_p, logs_p, x_mask = text_encoder(w, ops, model, batch["text"], batch["text_lengths"],
                                          drop)
    g = w["emb_g.weight"][batch["sid"]] if "emb_g.weight" in w else None
    y_len = batch["y_wav_lengths"] // data["hop_length"]
    z, _, logs_q, y_mask = rt.posterior(w, ops, model, spec, y_len, g, draw["eps"])
    z_p = rt.flow_forward(w, ops, z, y_mask, g)
    attn = maximum_path(neg_cent(ops, z_p.detach(), m_p.detach(), logs_p.detach()),
                        batch["text_lengths"], y_len)
    dur = torch.sum(attn, dim=2)[..., None]
    l_length = sdp_nll(w, ops, h, x_mask, dur, g, draw["e_q"], drop_sdp) / torch.sum(x_mask)
    attn_t = attn.transpose(1, 2)
    m_p, logs_p = ops.mm(attn_t, m_p), ops.mm(attn_t, logs_p)
    seg = cfg["train"]["segment_size"] // data["hop_length"]
    o = ref.decoder(w, ops, model, rt.slice_segments(z, draw["ids_str"], seg), g)
    return o, l_length, attn, z_p, m_p, logs_p, logs_q, y_mask


def mpd(w, ops: Ops, model: dict, y, y_hat):
    """The multi-period discriminator on [target; generated] -> (logits_r,
    logits_g, fmaps_r, fmaps_g), one pass a head."""
    b = y.shape[0]
    x = torch.cat([y, y_hat], dim=0)
    heads = [rt._scale_head(w, ops, "mpd.disc_s", x)]
    heads += [rt._period_head(w, ops, f"mpd.disc_p{p}", p, x)
              for p in model["multi_period_discriminator_periods"]]
    out = [(lg[:b], lg[b:], [f[:b] for f in fm], [f[b:] for f in fm]) for lg, fm in heads]
    return tuple(list(t) for t in zip(*out))


# -------------------------------------------------------------------- step
def train_steps(gw: Dict[str, torch.Tensor], dw: Dict[str, torch.Tensor], cfg: dict,
                batches: Sequence[dict], draws: Sequence[dict], seed: int,
                precision: Optional[str] = None, lr: Optional[float] = None) -> dict:
    """len(batches) steps from the weights gw (generator) and dw (the
    discriminator), updated in place. A batch holds "text", "text_lengths",
    "y_wav", "y_wav_lengths", "sid"; `draws[i]` step i's "eps" [B, T_y,
    inter], "e_q" [B, T_x, 2] and "ids_str" [B]. Dropout draws from a
    generator seeded with seed + 1 (none on the meta device). Returns
    {"g_total", "d_total": per-step losses, "g_terms": each step's G terms
    by the program's metric names less "loss/g/", "grads": {"gen." or
    "disc." + name: the first step's gradient}, "paths": each step's
    alignment}."""
    model, train = cfg["model"], cfg["train"]
    data = target_data(cfg["data"])
    ops = Ops(precision)
    dev = next(iter(gw.values())).device
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed + 1)
    drop = rt.Dropout(model["p_dropout"], gen)
    drop_sdp = rt.Dropout(SDP_DROPOUT, gen)
    lr = float(np.float32(train["learning_rate"])) if lr is None else lr
    opt_g = rt.AdamW(gw, lr, tuple(train["betas"]), train["eps"])
    opt_d = rt.AdamW(dw, lr, tuple(train["betas"]), train["eps"])
    hop, seg = data["hop_length"], train["segment_size"]
    out = {"g_total": [], "d_total": [], "g_terms": [], "grads": {}, "paths": []}
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        with torch.no_grad():
            spec, mel = rt.target_spec_mel(batch["y_wav"], data)
        for p in gw.values():
            p.requires_grad_(True)
        o, l_length, attn, z_p, m_p, logs_p, logs_q, y_mask = generator(
            gw, ops, cfg, batch, spec, dr, drop, drop_sdp)
        y_seg = rt.slice_segments(batch["y_wav"][:, :, None], dr["ids_str"] * hop, seg)
        dw_frozen = {k: v.detach() for k, v in dw.items()}
        _, p_lg, p_fr, p_fg = mpd(dw_frozen, ops, model, y_seg, o)
        loss_mel = torch.mean(torch.abs(rt.mel_of(o[:, :, 0], data)
                                        - rt.slice_segments(mel, dr["ids_str"], seg // hop)))
        terms = {"p_gen": rt.generator_loss(p_lg), "p_fm": rt.feature_loss(p_fr, p_fg),
                 "kl": rt.kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * train["c_kl"],
                 "mel": loss_mel * train["c_mel"], "dur": torch.sum(l_length) * C_DUR}
        loss_g = terms["p_gen"] + terms["p_fm"] + terms["kl"] + terms["mel"] + terms["dur"]
        names = list(gw)
        grads = torch.autograd.grad(loss_g, [gw[k] for k in names], allow_unused=True)
        g_grads = {k: (gr if gr is not None else torch.zeros_like(gw[k])).detach()
                   for k, gr in zip(names, grads)}
        for p in gw.values():
            p.requires_grad_(False)
        opt_g.step(g_grads)
        out["g_total"].append(loss_g.detach())
        out["g_terms"].append({k: v.detach() for k, v in terms.items()})
        out["paths"].append(attn)
        o = o.detach()
        del z_p, m_p, logs_p, logs_q, grads, l_length
        for p in dw.values():
            p.requires_grad_(True)
        p_lr, p_lg, _, _ = mpd(dw, ops, model, y_seg, o)
        loss_d = rt.discriminator_loss(p_lr, p_lg)
        dnames = list(dw)
        dgr = torch.autograd.grad(loss_d, [dw[k] for k in dnames], allow_unused=True)
        d_grads = {k: (gr if gr is not None else torch.zeros_like(dw[k])).detach()
                   for k, gr in zip(dnames, dgr)}
        for p in dw.values():
            p.requires_grad_(False)
        opt_d.step(d_grads)
        out["d_total"].append(loss_d.detach())
        if i == 0:
            out["grads"] = {**{"gen." + k: v for k, v in g_grads.items()},
                            **{"disc." + k: v for k, v in d_grads.items()}}
        del o, dgr, d_grads, g_grads
    return out
