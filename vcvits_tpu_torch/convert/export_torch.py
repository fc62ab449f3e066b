"""The port's state dicts -> a reference-style (Lightning) torch checkpoint.

The port's counterpart of vcvits_tpu/convert/export_torch.py, the inverse
of convert/vcvits_torch.py: a model trained in the port can be handed to a
user of the reference as `net_g.*`, `net_period_d.*` and `net_scale_d.*`
tensors in the reference's layouts. Weight-norm parameters export as
`weight_v` / `weight_g`, plain convs as `weight`, Linear layers of the
attention as 1x1 convs, LayerNorms as gamma / beta, and HuBERT in fairseq
naming (its positional conv folded). Import after export is the identity
(tests/test_torch_convert_reference.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.hubert_torch import _np, export_hubert_state_dict
from vcvits_tpu_torch.convert.vcvits_torch import _sub

Array = np.ndarray
SD = Dict[str, Array]


def _plain(sd: SD, src: str, dst: str, out: SD, unsqueeze: bool = False) -> None:
    w = sd[f"{src}.weight"].astype(np.float32)
    out[f"{dst}.weight"] = w[:, :, None] if unsqueeze else w
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"].astype(np.float32)


def _wn(sd: SD, src: str, dst: str, out: SD) -> None:
    out[f"{dst}.weight_v"] = sd[f"{src}.v"].astype(np.float32)
    out[f"{dst}.weight_g"] = sd[f"{src}.g"].astype(np.float32)
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"].astype(np.float32)


def _layernorm(sd: SD, src: str, dst: str, out: SD) -> None:
    out[f"{dst}.gamma"] = sd[f"{src}.weight"].astype(np.float32)
    out[f"{dst}.beta"] = sd[f"{src}.bias"].astype(np.float32)


def _wn_block(sd: SD, src: str, dst: str, out: SD) -> None:
    if f"{src}.cond_layer.v" in sd:
        _wn(sd, f"{src}.cond_layer", f"{dst}.cond_layer", out)
    i = 0
    while f"{src}.in_{i}.v" in sd:
        _wn(sd, f"{src}.in_{i}", f"{dst}.in_layers.{i}", out)
        _wn(sd, f"{src}.res_skip_{i}", f"{dst}.res_skip_layers.{i}", out)
        i += 1


def export_generator(gen_sd: Mapping, cfg: Config) -> SD:
    """The port's SynthesizerSVC state dict -> the reference's `net_g.`-less
    state dict (float32 arrays)."""
    sd = _np(gen_sd)
    m = cfg.model
    out: SD = {}
    hub = _sub(sd, "enc_p.hubert.")
    if hub:
        out.update(export_hubert_state_dict(hub, "enc_p.hubert."))
    _plain(sd, "enc_p.hubert_proj", "enc_p.hubert_proj", out)
    out["enc_p.emb_pitch.weight"] = sd["enc_p.emb_pitch.weight"].astype(np.float32)
    i = 0
    while f"enc_p.encoder.attn_{i}.conv_q.weight" in sd:
        src, dst = f"enc_p.encoder.attn_{i}", f"enc_p.encoder.attn_layers.{i}"
        for p in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _plain(sd, f"{src}.{p}", f"{dst}.{p}", out, unsqueeze=True)
        for e in ("emb_rel_k", "emb_rel_v"):
            out[f"{dst}.{e}"] = sd[f"{src}.{e}"].astype(np.float32)
        _layernorm(sd, f"enc_p.encoder.norm1_{i}", f"enc_p.encoder.norm_layers_1.{i}", out)
        for c in ("conv_1", "conv_2"):
            _plain(sd, f"enc_p.encoder.ffn_{i}.{c}", f"enc_p.encoder.ffn_layers.{i}.{c}", out)
        _layernorm(sd, f"enc_p.encoder.norm2_{i}", f"enc_p.encoder.norm_layers_2.{i}", out)
        i += 1
    _plain(sd, "enc_p.proj", "enc_p.proj", out)

    _plain(sd, "enc_q.pre", "enc_q.pre", out)
    _wn_block(sd, "enc_q.enc", "enc_q.enc", out)
    _plain(sd, "enc_q.proj", "enc_q.proj", out)
    i = 0
    while f"flow.flow_{i}.pre.weight" in sd:
        src, dst = f"flow.flow_{i}", f"flow.flows.{2 * i}"
        _plain(sd, f"{src}.pre", f"{dst}.pre", out)
        _wn_block(sd, f"{src}.enc", f"{dst}.enc", out)
        _plain(sd, f"{src}.post", f"{dst}.post", out)
        i += 1
    if "emb_g.weight" in sd:
        out["emb_g.weight"] = sd["emb_g.weight"].astype(np.float32)

    if "dec.conv_pre.v" in sd:
        _wn(sd, "dec.conv_pre", "dec.conv_pre", out)
        nk = len(m.resblock_kernel_sizes)
        for i in range(len(m.upsample_rates)):
            _wn(sd, f"dec.up_{i}", f"dec.ups.{i}", out)
            for j in range(nk):
                src, rb = f"dec.res_{i}_{j}", f"dec.resblocks.{i * nk + j}"
                for t in range(len(m.resblock_dilation_sizes[j])):
                    if m.resblock == "1":
                        _wn(sd, f"{src}.c1_{t}", f"{rb}.convs1.{t}", out)
                        _wn(sd, f"{src}.c2_{t}", f"{rb}.convs2.{t}", out)
                    else:
                        _wn(sd, f"{src}.c_{t}", f"{rb}.convs.{t}", out)
        _wn(sd, "dec.conv_post", "dec.conv_post", out)
        if "dec.cond.weight" in sd:
            _plain(sd, "dec.cond", "dec.cond", out, unsqueeze=True)
    return out


def export_discriminators(disc_sd: Mapping, cfg: Config) -> SD:
    """The port's Discriminators state dict -> net_period_d.* / net_scale_d.*."""
    sd = _np(disc_sd)
    out: SD = {}

    def head(src: str, dst: str, n: int) -> None:
        for i in range(n):
            _wn(sd, f"{src}.conv_{i}", f"{dst}.convs.{i}", out)
        _wn(sd, f"{src}.conv_post", f"{dst}.conv_post", out)

    head("mpd.disc_s", "net_period_d.discriminators.0", 6)
    for idx, period in enumerate(cfg.model.multi_period_discriminator_periods):
        head(f"mpd.disc_p{period}", f"net_period_d.discriminators.{idx + 1}", 5)
    for i in range(5):
        head(f"msd.disc_{i}", f"net_scale_d.discriminators.{i}", 6)
    return out


def export_lightning_checkpoint(path: str, gen_sd: Mapping, cfg: Config,
                                disc_sd: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Write a torch-loadable `.ckpt` with the reference's prefixed keys
    ({"state_dict": {...}}); returns that state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in export_generator(gen_sd, cfg).items():
        sd[f"net_g.{k}"] = torch.from_numpy(np.ascontiguousarray(v))
    if disc_sd is not None:
        for k, v in export_discriminators(disc_sd, cfg).items():
            sd[k] = torch.from_numpy(np.ascontiguousarray(v))
    torch.save({"state_dict": sd}, path)
    return sd
