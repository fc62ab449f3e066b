"""fairseq / transformers HuBERT checkpoints <-> the port's HubertModel.

The port's copy of vcvits_tpu/convert/hubert_torch.py (with the inverse
of its exporter, vcvits_tpu/convert/export_torch.py:export_hubert_state_dict),
mapping straight between the reference's torch layouts and the port's
state dict, which keeps PyTorch layouts. `convert_hubert_state_dict` takes
a flat {name: array} state dict in fairseq naming (the reference loads
fairseq ensembles) or transformers naming and returns the state dict of
`models/hubert.py:HubertModel`; the weight-normed positional conv is
folded to a plain kernel (dim 2), as the JAX package does, since HuBERT is
frozen. `export_hubert_state_dict` writes fairseq naming back.
`load_fairseq_checkpoint` reads a fairseq `.pt` (its "model" entry) from
disk; nothing is downloaded.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vcvits_tpu_torch.models.hubert import HubertConfig

Array = np.ndarray


def _np(sd: Mapping) -> Dict[str, Array]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()}


def _to_torch(sd: Mapping[str, Array]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32) for k, v in sd.items()}


def _fold_weight_norm_dim2(g: Array, v: Array) -> Array:
    """torch weight_norm(dim=2) on a conv weight [out, in, k]."""
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _is_fairseq(sd: Mapping[str, Array]) -> bool:
    return any(k.startswith("encoder.layers.0.self_attn.") for k in sd)


def convert_hubert_arrays(sd: Mapping, cfg: HubertConfig) -> Dict[str, Array]:
    """Flat fairseq or transformers state dict -> the port's HubertModel
    state dict as float32 numpy arrays."""
    sd = _np(sd)
    fairseq = _is_fairseq(sd)
    out: Dict[str, Array] = {}

    def f32(name: str) -> Array:
        return sd[name].astype(np.float32)

    def pair(src: str, dst: str) -> None:
        out[f"{dst}.weight"], out[f"{dst}.bias"] = f32(f"{src}.weight"), f32(f"{src}.bias")

    for i in range(len(cfg.conv_layers)):
        src = (f"feature_extractor.conv_layers.{i}.0" if fairseq
               else f"feature_extractor.conv_layers.{i}.conv")
        out[f"feature_extractor.conv_{i}.weight"] = f32(f"{src}.weight")
        if cfg.conv_bias:
            out[f"feature_extractor.conv_{i}.bias"] = f32(f"{src}.bias")
    pair("feature_extractor.conv_layers.0.2" if fairseq
         else "feature_extractor.conv_layers.0.layer_norm", "feature_extractor.group_norm")
    pair("layer_norm" if fairseq else "feature_projection.layer_norm", "feat_ln")
    pair("post_extract_proj" if fairseq else "feature_projection.projection",
         "post_extract_proj")

    pc = "encoder.pos_conv.0" if fairseq else "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        w = _fold_weight_norm_dim2(sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"])
    elif f"{pc}.parametrizations.weight.original0" in sd:
        w = _fold_weight_norm_dim2(sd[f"{pc}.parametrizations.weight.original0"],
                                   sd[f"{pc}.parametrizations.weight.original1"])
    else:
        w = sd[f"{pc}.weight"]
    out["pos_conv.weight"], out["pos_conv.bias"] = w.astype(np.float32), f32(f"{pc}.bias")
    pair("encoder.layer_norm", "encoder_ln")

    for i in range(cfg.num_layers):
        base, dst = f"encoder.layers.{i}", f"layer_{i}"
        attn = f"{base}.self_attn" if fairseq else f"{base}.attention"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            pair(f"{attn}.{p}", f"{dst}.attn.{p}")
        if fairseq:
            pair(f"{base}.self_attn_layer_norm", f"{dst}.ln1")
            pair(f"{base}.fc1", f"{dst}.fc1")
            pair(f"{base}.fc2", f"{dst}.fc2")
        else:
            pair(f"{base}.layer_norm", f"{dst}.ln1")
            pair(f"{base}.feed_forward.intermediate_dense", f"{dst}.fc1")
            pair(f"{base}.feed_forward.output_dense", f"{dst}.fc2")
        pair(f"{base}.final_layer_norm", f"{dst}.ln2")
    return out


def convert_hubert_state_dict(sd: Mapping, cfg: HubertConfig) -> Dict[str, torch.Tensor]:
    """Flat fairseq or transformers state dict -> float32 state dict of the
    port's HubertModel."""
    return _to_torch(convert_hubert_arrays(sd, cfg))


def export_hubert_state_dict(sd: Mapping, prefix: str = "") -> Dict[str, Array]:
    """The port's HubertModel state dict -> fairseq-named float32 arrays
    (the positional conv exported folded), each name prefixed; the inverse
    of `convert_hubert_state_dict`."""
    sd = _np(sd)
    out: Dict[str, Array] = {}

    def pair(src: str, dst: str) -> None:
        out[f"{prefix}{dst}.weight"] = sd[f"{src}.weight"].astype(np.float32)
        out[f"{prefix}{dst}.bias"] = sd[f"{src}.bias"].astype(np.float32)

    i = 0
    while f"feature_extractor.conv_{i}.weight" in sd:
        dst = f"{prefix}feature_extractor.conv_layers.{i}.0"
        out[f"{dst}.weight"] = sd[f"feature_extractor.conv_{i}.weight"].astype(np.float32)
        if f"feature_extractor.conv_{i}.bias" in sd:
            out[f"{dst}.bias"] = sd[f"feature_extractor.conv_{i}.bias"].astype(np.float32)
        i += 1
    pair("feature_extractor.group_norm", "feature_extractor.conv_layers.0.2")
    pair("feat_ln", "layer_norm")
    pair("post_extract_proj", "post_extract_proj")
    pair("pos_conv", "encoder.pos_conv.0")
    pair("encoder_ln", "encoder.layer_norm")
    i = 0
    while f"layer_{i}.fc1.weight" in sd:
        src, base = f"layer_{i}", f"encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            pair(f"{src}.attn.{p}", f"{base}.self_attn.{p}")
        pair(f"{src}.ln1", f"{base}.self_attn_layer_norm")
        pair(f"{src}.fc1", f"{base}.fc1")
        pair(f"{src}.fc2", f"{base}.fc2")
        pair(f"{src}.ln2", f"{base}.final_layer_norm")
        i += 1
    return out


def load_fairseq_checkpoint(path: str, cfg: HubertConfig) -> Dict[str, torch.Tensor]:
    """A fairseq HuBERT `.pt` (its "model" entry, or a bare state dict) ->
    the port's HubertModel state dict. The file is a pickle, read with
    torch.load(weights_only=False): load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return convert_hubert_state_dict({k: v for k, v in sd.items()
                                      if isinstance(v, torch.Tensor)}, cfg)
