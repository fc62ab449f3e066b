"""Reference VCVITS (PyTorch Lightning) checkpoints -> the port's state dicts.

The port's counterpart of vcvits_tpu/convert/vcvits_torch.py. A user of the
reference brings a trained checkpoint (`*.ckpt`, keys like
`net_g.enc_q.enc.in_layers.0.weight_v`) to the port. The port keeps the
reference's PyTorch layouts, so each tensor maps straight to a port
parameter: mostly a rename, a 1x1 attention conv squeezed to a Linear
weight, LayerNorm gamma/beta to weight/bias, and HuBERT through
convert/hubert_torch.py. Weight-norm pairs (weight_g, weight_v, or the
parametrizations' original0/original1) stay (g, v); a plain conv where the
port has weight norm is wrapped as v = W, g = ||W|| per output channel (the
same folded kernel). A decoder without the speaker `cond` projection (the
torch.hub vocoder) gets a zero one, which reproduces it exactly. Values
are taken as float32 numpy arrays and computed as the JAX converter
computes them, so a checkpoint loads bit for bit as
`params_from_jax(convert_generator(...))` of the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.hubert_torch import _np, _to_torch, convert_hubert_arrays
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.models.synthesizer import hubert_config_for

Array = np.ndarray
SD = Dict[str, Array]


def _sub(sd: Mapping, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def _plain(sd: SD, src: str, dst: str, out: SD, squeeze: bool = False) -> None:
    """A plain conv / linear `src` -> `dst`.weight (a 1x1 conv squeezed to a
    Linear weight with `squeeze`), and its bias."""
    w = sd[f"{src}.weight"]
    out[f"{dst}.weight"] = (w[:, :, 0] if squeeze else w).astype(np.float32)
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"].astype(np.float32)


def _wn(sd: SD, src: str, dst: str, out: SD) -> None:
    """A weight-normed conv (1-D, transposed or 2-D) -> `dst`.{v, g, bias}."""
    if f"{src}.weight_v" in sd:
        v, g = sd[f"{src}.weight_v"], sd[f"{src}.weight_g"]
    elif f"{src}.parametrizations.weight.original1" in sd:
        g = sd[f"{src}.parametrizations.weight.original0"]
        v = sd[f"{src}.parametrizations.weight.original1"]
    else:  # plain conv: wrap as weight norm with g = ||W||
        v = sd[f"{src}.weight"]
        g = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1)
    out[f"{dst}.v"] = v.astype(np.float32)
    out[f"{dst}.g"] = g.reshape(-1, *([1] * (v.ndim - 1))).astype(np.float32)
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"].astype(np.float32)


def _layernorm(sd: SD, src: str, dst: str, out: SD) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.gamma"].astype(np.float32)
    out[f"{dst}.bias"] = sd[f"{src}.beta"].astype(np.float32)


def _wn_block(sd: SD, src: str, dst: str, n_layers: int, has_cond: bool, out: SD) -> None:
    if has_cond:
        _wn(sd, f"{src}.cond_layer", f"{dst}.cond_layer", out)
    for i in range(n_layers):
        _wn(sd, f"{src}.in_layers.{i}", f"{dst}.in_{i}", out)
        _wn(sd, f"{src}.res_skip_layers.{i}", f"{dst}.res_skip_{i}", out)


def generator_arrays(sd: Mapping, cfg: Config, hubert_cfg: Optional[HubertConfig] = None,
                     n_flows: int = 4, wn_layers_q: int = 16) -> SD:
    """`net_g.`-less reference state dict -> the port's SynthesizerSVC
    state dict as float32 arrays."""
    sd = _np(sd)
    m = cfg.model
    out: SD = {}
    hub = _sub(sd, "enc_p.hubert.")
    if hub:
        for k, v in convert_hubert_arrays(
                hub, hubert_cfg or hubert_config_for(m.hubert_channels)).items():
            out[f"enc_p.hubert.{k}"] = v
    _plain(sd, "enc_p.hubert_proj", "enc_p.hubert_proj", out)
    out["enc_p.emb_pitch.weight"] = sd["enc_p.emb_pitch.weight"].astype(np.float32)
    for i in range(m.n_layers):
        src, dst = f"enc_p.encoder.attn_layers.{i}", f"enc_p.encoder.attn_{i}"
        for p in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _plain(sd, f"{src}.{p}", f"{dst}.{p}", out, squeeze=True)
        for e in ("emb_rel_k", "emb_rel_v"):
            out[f"{dst}.{e}"] = sd[f"{src}.{e}"].astype(np.float32)
        _layernorm(sd, f"enc_p.encoder.norm_layers_1.{i}", f"enc_p.encoder.norm1_{i}", out)
        for c in ("conv_1", "conv_2"):
            _plain(sd, f"enc_p.encoder.ffn_layers.{i}.{c}", f"enc_p.encoder.ffn_{i}.{c}", out)
        _layernorm(sd, f"enc_p.encoder.norm_layers_2.{i}", f"enc_p.encoder.norm2_{i}", out)
    _plain(sd, "enc_p.proj", "enc_p.proj", out)

    has_cond = m.gin_channels > 0
    _plain(sd, "enc_q.pre", "enc_q.pre", out)
    _wn_block(sd, "enc_q.enc", "enc_q.enc", wn_layers_q, has_cond, out)
    _plain(sd, "enc_q.proj", "enc_q.proj", out)
    for i in range(n_flows):  # even indices are couplings, odd are flips
        src, dst = f"flow.flows.{2 * i}", f"flow.flow_{i}"
        _plain(sd, f"{src}.pre", f"{dst}.pre", out)
        _wn_block(sd, f"{src}.enc", f"{dst}.enc", 4, has_cond, out)
        _plain(sd, f"{src}.post", f"{dst}.post", out)
    if "emb_g.weight" in sd:
        out["emb_g.weight"] = sd["emb_g.weight"].astype(np.float32)
    if "dec.conv_pre.weight_v" in sd or "dec.conv_pre.weight" in sd:
        for k, v in decoder_arrays(sd, cfg, prefix="dec.").items():
            out[f"dec.{k}"] = v
    return out


def decoder_arrays(sd: Mapping, cfg: Config, prefix: str = "") -> SD:
    """A HiFi-GAN generator state dict -> the port's HiFiGANGenerator state
    dict as float32 arrays. prefix "dec." takes the decoder of a whole
    VCVITS checkpoint; "" a standalone torch.hub vocoder checkpoint (the
    reference's `hifigan_48k`: conv_pre, ups.N, resblocks.N.convs1.T /
    convs.T, conv_post)."""
    sd = _np(sd)
    m = cfg.model
    out: SD = {}
    _wn(sd, f"{prefix}conv_pre", "conv_pre", out)
    nk = len(m.resblock_kernel_sizes)
    for i in range(len(m.upsample_rates)):
        _wn(sd, f"{prefix}ups.{i}", f"up_{i}", out)
        for j in range(nk):
            rb, dst = f"{prefix}resblocks.{i * nk + j}", f"res_{i}_{j}"
            for t in range(len(m.resblock_dilation_sizes[j])):
                if m.resblock == "1":
                    _wn(sd, f"{rb}.convs1.{t}", f"{dst}.c1_{t}", out)
                    _wn(sd, f"{rb}.convs2.{t}", f"{dst}.c2_{t}", out)
                else:
                    _wn(sd, f"{rb}.convs.{t}", f"{dst}.c_{t}", out)
    _wn(sd, f"{prefix}conv_post", "conv_post", out)
    if f"{prefix}cond.weight" in sd:
        _plain(sd, f"{prefix}cond", "cond", out, squeeze=True)
    elif m.gin_channels > 0:
        # the hub vocoder is not speaker-conditioned; a zero projection keeps it exact
        out["cond.weight"] = np.zeros((m.upsample_initial_channel, m.gin_channels), np.float32)
        out["cond.bias"] = np.zeros((m.upsample_initial_channel,), np.float32)
    return out


def discriminator_arrays(sd: Mapping, cfg: Config) -> SD:
    """net_period_d.* / net_scale_d.* -> the port's Discriminators state
    dict (mpd.*, msd.*) as float32 arrays."""
    sd = _np(sd)
    out: SD = {}

    def disc_s(src: str, dst: str) -> None:
        for i in range(6):
            _wn(sd, f"{src}.convs.{i}", f"{dst}.conv_{i}", out)
        _wn(sd, f"{src}.conv_post", f"{dst}.conv_post", out)

    def disc_p(src: str, dst: str) -> None:
        for i in range(5):
            _wn(sd, f"{src}.convs.{i}", f"{dst}.conv_{i}", out)
        _wn(sd, f"{src}.conv_post", f"{dst}.conv_post", out)

    disc_s("net_period_d.discriminators.0", "mpd.disc_s")
    for idx, period in enumerate(cfg.model.multi_period_discriminator_periods):
        disc_p(f"net_period_d.discriminators.{idx + 1}", f"mpd.disc_p{period}")
    for i in range(5):
        disc_s(f"net_scale_d.discriminators.{i}", f"msd.disc_{i}")
    return out


def convert_generator(sd: Mapping, cfg: Config, hubert_cfg: Optional[HubertConfig] = None
                      ) -> Dict[str, torch.Tensor]:
    """`net_g.`-less reference state dict -> the port's SynthesizerSVC
    state dict (float32 tensors)."""
    return _to_torch(generator_arrays(sd, cfg, hubert_cfg))


def convert_hifigan_generator(sd: Mapping, cfg: Config, prefix: str = ""
                              ) -> Dict[str, torch.Tensor]:
    """A HiFi-GAN generator state dict -> the port's HiFiGANGenerator state
    dict (`decoder_arrays`)."""
    return _to_torch(decoder_arrays(sd, cfg, prefix))


def convert_discriminators(sd: Mapping, cfg: Config) -> Dict[str, torch.Tensor]:
    """net_period_d.* / net_scale_d.* -> the port's Discriminators state dict."""
    return _to_torch(discriminator_arrays(sd, cfg))


def convert_lightning_checkpoint(path: str, cfg: Config,
                                 hubert_cfg: Optional[HubertConfig] = None
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            Optional[Dict[str, torch.Tensor]]]:
    """A reference Lightning `.ckpt` -> (generator state dict, discriminators'
    state dict or None). The file is a pickle, read with
    torch.load(weights_only=False) as Lightning writes more than tensors:
    load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    gen = convert_generator(_sub(sd, "net_g."), cfg, hubert_cfg)
    disc = (convert_discriminators(sd, cfg)
            if any(k.startswith("net_period_d.") for k in sd) else None)
    return gen, disc
