"""The plain reference of the conversion model's GAN train step.

What `TrainStep.__call__` computes, restated in plain float32 PyTorch
with autograd, on raw weights under the program's parameter names (the
generator's, benchmark/reference/vc.py:param_specs, and the
discriminators', `disc_specs`):

1. frozen features: the 16 kHz source smoothed by an STFT -> iSTFT round
   trip, HuBERT on it once, the target's magnitude spectrogram and log-mel
   by a float64 DFT;
2. generator: the prior (HuBERT features -> projection + pitch embedding
   -> relative-position transformer with dropout), the posterior encoder
   (WaveNet, with the injected noise), the flow forward, the prior taken to
   the spectrogram frames, the injected segment through the HiFi-GAN
   decoder, MPD (one scale head and a head per period) and MSD (five scale
   heads) on the [target; generated] segment, and
   total = s_gen + s_fm + p_gen + p_fm + c_mel * mel-L1 + c_kl * KL;
   backward; AdamW (weight decay 0.01) on every parameter but HuBERT's;
3. discriminators: the generator forward again with the updated weights,
   the second injected noise and segment, no gradient; the LS-GAN loss of
   both discriminators; backward; AdamW.

Dropout masks are drawn as the program draws them, `rand(shape) >= rate`
in float32 from a generator on the device seeded with the step's seed + 1,
in the order the program draws them; the posterior's noise and the
segment starts are the benchmark's draws, given to both sides. Weight norm
is folded here from `v` and `g`. Imports nothing of the program or of JAX.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import vc as ref
from benchmark.reference.vc import Ops, kernel

# (features, kernel, stride, groups, padding) of a scale head's convs
SCALE_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
               (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))
PERIOD_CHANNELS = (32, 128, 512, 1024)
MSD_SCALES = 5


def disc_specs(model: dict) -> List[tuple]:
    """(name, shape, kind) of the discriminators' parameters (weight norm
    everywhere, use_spectral_norm false), in the program's names."""
    s: list = []

    def scale_head(prefix):
        cin = 1
        for i, (f, k, _, g, _) in enumerate(SCALE_SPECS):
            ref._conv(s, f"{prefix}.conv_{i}", (f, cin // g, k), wn=True)
            cin = f
        ref._conv(s, f"{prefix}.conv_post", (1, cin, 3), wn=True)

    scale_head("mpd.disc_s")
    for p in model["multi_period_discriminator_periods"]:
        cin = 1
        for i, ch in enumerate(PERIOD_CHANNELS):
            ref._conv(s, f"mpd.disc_p{p}.conv_{i}", (ch, cin, 5, 1), wn=True)
            cin = ch
        ref._conv(s, f"mpd.disc_p{p}.conv_4", (1024, 1024, 5, 1), wn=True)
        ref._conv(s, f"mpd.disc_p{p}.conv_post", (1, 1024, 3, 1), wn=True)
    for i in range(MSD_SCALES):
        scale_head(f"msd.disc_{i}")
    return s


def trainable(name: str) -> bool:
    """Every generator parameter but the frozen HuBERT's."""
    return "hubert" not in name.split(".")


# ------------------------------------------------------------------ signal
def _window(n_fft: int, win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    return win


@lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalised mel filterbank [n_mels, n_fft//2+1],
    float32 (librosa.filters.mel's algorithm)."""
    fmax = sr / 2.0 if fmax is None else fmax
    min_log_hz, min_log_mel, logstep = 1000.0, 1000.0 / (200.0 / 3.0), math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asanyarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / (200.0 / 3.0))

    def mel_to_hz(m):
        m = np.asanyarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * (200.0 / 3.0))

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _reflect(y: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :] if pad else y


def stft(y: torch.Tensor, n_fft: int, hop: int, win: int):
    """(re, im) [B, frames, n_fft//2+1]: reflect pad (n_fft - hop) / 2,
    periodic Hann, no centring."""
    frames = _reflect(y, (n_fft - hop) // 2).unfold(-1, n_fft, hop)
    w = torch.as_tensor(_window(n_fft, win).astype(np.float32), device=y.device)
    spec = torch.fft.rfft(frames * w, dim=-1)
    return spec.real, spec.imag


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    _, n_frames, n = frames.shape
    total = n + hop * (n_frames - 1)
    return F.fold(frames.transpose(1, 2), (1, total), (1, n), stride=(1, hop))[:, 0, 0]


def smooth_source(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """The STFT -> iSTFT round trip (torch.istft's centre trimming), cut or
    zero-padded back to the input's length."""
    re, im = stft(x, n_fft, hop, win)
    w = torch.as_tensor(_window(n_fft, win).astype(np.float32), device=x.device)
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1) * w
    wav = _overlap_add(frames, hop)
    wsq = _overlap_add((w * w).expand(1, re.shape[1], n_fft), hop)
    wav = (wav / torch.clamp_min(wsq, 1e-11))[:, n_fft // 2:wav.shape[-1] - n_fft // 2]
    out = torch.zeros_like(x)
    n = min(x.shape[-1], wav.shape[-1])
    out[:, :n] = wav[:, :n]
    return out


def mel_of(o: torch.Tensor, d: dict) -> torch.Tensor:
    """The generated segment's log-mel, differentiable: |STFT| with the
    1e-6 floor, the filterbank, log of the clamp at 1e-5."""
    re, im = stft(o, d["filter_length"], d["hop_length"], d["win_length"])
    spec = torch.sqrt(re * re + im * im + 1e-6)
    fb = torch.as_tensor(mel_filterbank(d["target_sampling_rate"], d["filter_length"],
                                        d["n_mel_channels"], d["mel_fmin"], d["mel_fmax"]),
                         device=o.device)
    return torch.log(torch.clamp_min(spec @ fb.t(), 1e-5))


def target_spec_mel(y: torch.Tensor, d: dict):
    """The target's (spectrogram, log-mel) by a float64 DFT, as float32."""
    n_fft, hop, win = d["filter_length"], d["hop_length"], d["win_length"]
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * math.pi * np.outer(np.arange(n_fft), k) / n_fft
    w = _window(n_fft, win)
    cos_b = torch.as_tensor(np.cos(ang) * w[:, None], device=y.device)
    sin_b = torch.as_tensor(-np.sin(ang) * w[:, None], device=y.device)
    fr = _reflect(y.double(), (n_fft - hop) // 2).unfold(-1, n_fft, hop)
    re, im = fr @ cos_b, fr @ sin_b
    spec = torch.sqrt(re * re + im * im + 1e-6)
    fb = torch.as_tensor(mel_filterbank(d["target_sampling_rate"], n_fft, d["n_mel_channels"],
                                        d["mel_fmin"], d["mel_fmax"]).T.astype(np.float64),
                         device=y.device)
    return spec.float(), torch.log(torch.clamp_min(spec @ fb, 1e-5)).float()


def slice_segments(x: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    b, t, _ = x.shape
    s = torch.clamp(starts.to(torch.int64), 0, t - size)
    idx = s[:, None] + torch.arange(size, device=x.device)[None, :]
    return x[torch.arange(b, device=x.device)[:, None], idx]


# ------------------------------------------------------------------ models
class Dropout:
    """The program's dropout: keep where rand(shape) >= rate, scaled by
    1 / (1 - rate), the uniform draws from `gen` in call order."""

    def __init__(self, rate: float, gen: Optional[torch.Generator]):
        self.rate, self.gen = rate, gen

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), device=x.device))


def posterior(w, ops: Ops, model: dict, spec, lengths, g, eps):
    """(z, m_q, logs_q, mask) of the posterior encoder."""
    mask = ref.sequence_mask(lengths, spec.shape[1])
    h = ops.conv1d(spec, w["enc_q.pre.weight"], w["enc_q.pre.bias"]) * mask
    h = ref.wavenet(w, ops, "enc_q.enc", h, mask, g, ref.POST_LAYERS, ref.POST_K)
    stats = ops.conv1d(h, w["enc_q.proj.weight"], w["enc_q.proj.bias"]) * mask
    inter = model["inter_channels"]
    m, logs = stats[..., :inter], stats[..., inter:]
    return (m + eps * torch.exp(logs)) * mask, m, logs, mask


def flow_forward(w, ops: Ops, z, mask, g):
    half = z.shape[-1] // 2
    for i in range(ref.N_FLOWS):
        f = f"flow.flow_{i}"
        x0, x1 = z[..., :half], z[..., half:]
        h = ops.conv1d(x0, w[f"{f}.pre.weight"], w[f"{f}.pre.bias"]) * mask
        h = ref.wavenet(w, ops, f"{f}.enc", h, mask, g, ref.FLOW_LAYERS, ref.FLOW_K)
        m = ops.conv1d(h, w[f"{f}.post.weight"], w[f"{f}.post.bias"]) * mask
        z = torch.flip(torch.cat([x0, (m + x1) * mask], dim=-1), dims=[-1])
    return z


def generator(w, ops: Ops, cfg: dict, feats, batch, spec, eps, starts, drop):
    """The training forward -> (o [B, segment, 1], z_p, m_p, logs_p, logs_q,
    y_mask)."""
    model, data = cfg["model"], cfg["data"]
    m_p, logs_p = ref.prior(w, ops, model, feats, batch["x_wav_lengths"], batch["x_pitch"], drop)
    g = w["emb_g.weight"][batch["sid"]]
    y_len = batch["y_wav_lengths"] // data["hop_length"]
    z, _, logs_q, y_mask = posterior(w, ops, model, spec, y_len, g, eps)
    z_p = flow_forward(w, ops, z, y_mask, g)
    t_spec = spec.shape[1]
    m_p, logs_p = ref.nearest_interp(m_p, t_spec), ref.nearest_interp(logs_p, t_spec)
    seg = cfg["train"]["segment_size"] // data["hop_length"]
    o = ref.decoder(w, ops, model, slice_segments(z, starts, seg), g)
    return o, z_p, m_p, logs_p, logs_q, y_mask


def _scale_head(w, ops: Ops, prefix: str, x):
    fmap = []
    for i, (_, _, stride, groups, pad) in enumerate(SCALE_SPECS):
        c = f"{prefix}.conv_{i}"
        x = F.leaky_relu(ops.conv1d(x, kernel(w, c), w[f"{c}.bias"], pad=(pad, pad),
                                    stride=stride, groups=groups), ref.LRELU)
        fmap.append(x)
    x = ops.conv1d(x, kernel(w, f"{prefix}.conv_post"), w[f"{prefix}.conv_post.bias"], pad=(1, 1))
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def _period_head(w, ops: Ops, prefix: str, period: int, x):
    b, t, _ = x.shape
    if t % period:
        x = F.pad(x.transpose(1, 2), (0, period - t % period), mode="reflect").transpose(1, 2)
        t = x.shape[1]
    x = x.reshape(b, t // period, period).unsqueeze(1)          # NCHW
    fmap = []
    for i in range(5):
        c = f"{prefix}.conv_{i}"
        x = ops.g(F.conv2d(ops.r(x), ops.r(kernel(w, c)), w[f"{c}.bias"],
                           stride=(3 if i < 4 else 1, 1), padding=(2, 0)))
        x = F.leaky_relu(x, ref.LRELU)
        fmap.append(x)
    c = f"{prefix}.conv_post"
    x = ops.g(F.conv2d(ops.r(x), ops.r(kernel(w, c)), w[f"{c}.bias"], padding=(1, 0)))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def discriminators(w, ops: Ops, model: dict, y, y_hat):
    """(MPD, MSD) outputs, each (logits_r, logits_g, fmaps_r, fmaps_g), one
    pass of each head over [y; y_hat]."""
    b = y.shape[0]
    x = torch.cat([y, y_hat], dim=0)

    def split(out):
        logits, fmap = out
        return logits[:b], logits[b:], [f[:b] for f in fmap], [f[b:] for f in fmap]

    mpd = [split(_scale_head(w, ops, "mpd.disc_s", x))]
    mpd += [split(_period_head(w, ops, f"mpd.disc_p{p}", p, x))
            for p in model["multi_period_discriminator_periods"]]
    msd, xs = [], x
    for i in range(MSD_SCALES):
        if i:
            xs = F.avg_pool1d(xs.transpose(1, 2), 4, 2, padding=2,
                              count_include_pad=True).transpose(1, 2)
        msd.append(split(_scale_head(w, ops, f"msd.disc_{i}", xs)))
    return tuple([list(t) for t in zip(*heads)] for heads in (mpd, msd))


def feature_loss(fr, fg):
    return 2.0 * sum(torch.mean(torch.abs(r.detach() - g)) for dr, dg in zip(fr, fg)
                     for r, g in zip(dr, dg))


def generator_loss(lg):
    return sum(torch.mean((1.0 - g) ** 2) for g in lg)


def discriminator_loss(lr, lg):
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2) for r, g in zip(lr, lg))


def kl_loss(z_p, logs_q, m_p, logs_p, mask):
    kl = logs_p - logs_q - 0.5 + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * mask) / torch.sum(mask)


# ------------------------------------------------------------------- AdamW
class AdamW:
    """torch.optim.AdamW's arithmetic (decoupled weight decay, bias
    correction), one state a parameter."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas, eps, weight_decay=0.01):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


# -------------------------------------------------------------------- step
def train_steps(gw: Dict[str, torch.Tensor], dw: Dict[str, torch.Tensor], cfg: dict,
                hub: ref.Hubert, batches: Sequence[dict], draws: Sequence[dict], seed: int,
                precision: Optional[str] = None, lr: Optional[float] = None) -> dict:
    """len(batches) steps from the weights gw (generator) and dw
    (discriminators), updated in place. `draws[i]` holds step i's "eps",
    "ids_str", "eps2", "ids_str2"; the dropout generator is seeded with
    seed + 1, as the program's (on the meta device, which counts operations,
    nothing is dropped). Returns {"g_total", "d_total": per-step losses as
    0-dim tensors, "grads": {name: the first step's gradient} of every
    trained parameter, "gen." or "disc." before its name}."""
    model, data, train = cfg["model"], cfg["data"], cfg["train"]
    ops = Ops(precision)
    dev = next(iter(gw.values())).device
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed + 1)
    drop = Dropout(model["p_dropout"], gen)
    g_train = {k: v for k, v in gw.items() if trainable(k)}
    # the program's schedule is float32; its first 1000 steps run at lr0
    lr = float(np.float32(train["learning_rate"])) if lr is None else lr
    opt_g = AdamW(g_train, lr, tuple(train["betas"]), train["eps"])
    opt_d = AdamW(dw, lr, tuple(train["betas"]), train["eps"])
    hop, seg = data["hop_length"], train["segment_size"]
    out = {"g_total": [], "d_total": [], "grads": {}}
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        with torch.no_grad():
            x = smooth_source(batch["x_wav"], data["filter_length"], hop, data["win_length"])
            feats = ref.hubert(gw, ops, hub, F.pad(x, (ref.HUBERT_PAD, ref.HUBERT_PAD)))
            spec, mel = target_spec_mel(batch["y_wav"], data)
        for p in g_train.values():
            p.requires_grad_(True)
        o, z_p, m_p, logs_p, logs_q, y_mask = generator(gw, ops, cfg, feats, batch, spec,
                                                         dr["eps"], dr["ids_str"], drop)
        y_seg = slice_segments(batch["y_wav"][:, :, None], dr["ids_str"] * hop, seg)
        dw_frozen = {k: v.detach() for k, v in dw.items()}
        (p_lr, p_lg, p_fr, p_fg), (s_lr, s_lg, s_fr, s_fg) = discriminators(
            dw_frozen, ops, model, y_seg, o)
        loss_mel = torch.mean(torch.abs(mel_of(o[:, :, 0], data)
                                        - slice_segments(mel, dr["ids_str"], seg // hop)))
        loss_g = (generator_loss(s_lg) + feature_loss(s_fr, s_fg)) \
            + (generator_loss(p_lg) + feature_loss(p_fr, p_fg)) \
            + loss_mel * train["c_mel"] + kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * train["c_kl"]
        names = list(g_train)
        grads = torch.autograd.grad(loss_g, [g_train[k] for k in names], allow_unused=True)
        g_grads = {k: (gr if gr is not None else torch.zeros_like(g_train[k])).detach()
                   for k, gr in zip(names, grads)}
        for p in g_train.values():
            p.requires_grad_(False)
        opt_g.step(g_grads)
        out["g_total"].append(loss_g.detach())
        del o, z_p, m_p, logs_p, logs_q, grads
        with torch.no_grad():
            o2 = generator(gw, ops, cfg, feats, batch, spec, dr["eps2"], dr["ids_str2"], drop)[0]
        y_seg2 = slice_segments(batch["y_wav"][:, :, None], dr["ids_str2"] * hop, seg)
        for p in dw.values():
            p.requires_grad_(True)
        (p_lr, p_lg, _, _), (s_lr, s_lg, _, _) = discriminators(dw, ops, model, y_seg2, o2)
        loss_d = discriminator_loss(p_lr, p_lg) + discriminator_loss(s_lr, s_lg)
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
        del o2, dgr, d_grads, g_grads
    return out
