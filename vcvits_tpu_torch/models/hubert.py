"""HuBERT content-feature extractor (frozen), PyTorch.

Counterpart of vcvits_tpu/models/hubert.py: a 7-layer strided conv front
end (320x downsample, no conv bias, a per-channel GroupNorm on conv 0, exact
erf-GELU), `feat_ln` -> `post_extract_proj`, a grouped positional conv
(k=128, 16 groups, padded 64 each side, last frame dropped), `encoder_ln`,
then post-LN transformer layers. Under tensor parallelism attention is
column-parallel on q/k/v (each rank its contiguous heads) and row-parallel
on out_proj, the FFN column-parallel on fc1 and row-parallel on fc2, and
the grouped positional conv computes whole groups per rank and gathers
its channels (models/layers.py). Plain PyTorch ops throughout; the JAX
package's im2col of conv 0 is a TPU lane rewrite of the same conv and is
not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, LayerNorm, Linear
from vcvits_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class HubertConfig:
    # (dim, kernel, stride) per conv layer — fairseq "conv_feature_layers"
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 3, 2), (512, 2, 2), (512, 2, 2),
    )
    conv_bias: bool = False
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def downsample(self) -> int:
        """Input samples per output frame: the product of the strides."""
        d = 1
        for _, _, s in self.conv_layers:
            d *= s
        return d  # 320 for base

    @property
    def receptive_field(self) -> int:
        """Input samples one output frame sees."""
        rf, d = 1, 1
        for _, k, s in self.conv_layers:
            rf += (k - 1) * d
            d *= s
        return rf  # 400 for base


HUBERT_BASE = HubertConfig()
HUBERT_XTRALARGE = HubertConfig(
    hidden_size=1280, num_layers=48, num_heads=16, intermediate_size=5120,
)


def hubert_frames(num_samples: int, cfg: HubertConfig = HUBERT_BASE) -> int:
    """Output frames for a (padded) input of `num_samples` samples."""
    t = num_samples
    for _, k, s in cfg.conv_layers:
        t = (t - k) // s + 1
    return t


class GroupNormAll(nn.Module):
    """GroupNorm with groups == channels: each channel normalised over T."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class ConvFeatureExtractor(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype=torch.float32):
        super().__init__()
        self.n = len(cfg.conv_layers)
        in_ch = 1
        for i, (dim, k, s) in enumerate(cfg.conv_layers):
            self.add_module(f"conv_{i}", Conv1d(
                in_ch, dim, k, stride=s, padding="valid", bias=cfg.conv_bias,
                kernel_init="he_normal", dtype=dtype))
            in_ch = dim
        self.group_norm = GroupNormAll(cfg.conv_layers[0][0], dtype=dtype)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T/320, 512]."""
        x = wav[:, :, None]
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.group_norm(x)
            x = F.gelu(x)
        return x


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Linear(hidden, hidden, dtype=dtype))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, c = x.shape
        d = c // self.heads
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        # under tensor parallelism q/k/v hold this rank's contiguous heads
        h = q.shape[-1] // d

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        scores = torch.matmul(q / d ** 0.5, k.transpose(-1, -2))
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :] == 0,
                                        torch.finfo(torch.float32).min)
        p = torch.softmax(scores, dim=-1)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, t, h * d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-LN transformer block (fairseq base, layer_norm_first=False)."""

    def __init__(self, cfg: HubertConfig, dtype=torch.float32):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn = SelfAttention(h, cfg.num_heads, dtype=dtype)
        self.ln1 = LayerNorm(h, eps, dtype=dtype)
        self.fc1 = Linear(h, cfg.intermediate_size, dtype=dtype)
        self.fc2 = Linear(cfg.intermediate_size, h, dtype=dtype)
        self.ln2 = LayerNorm(h, eps, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.ln1(x + self.attn(x, mask))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x + h)


class PositionalConvEmbedding(Conv1d):
    """Grouped positional conv; an even kernel with symmetric padding
    overshoots by one frame, which is dropped."""

    def __init__(self, cfg: HubertConfig, dtype=torch.float32):
        k = cfg.pos_conv_kernel
        super().__init__(cfg.hidden_size, cfg.hidden_size, k, groups=cfg.pos_conv_groups,
                         padding=(k // 2, k // 2), kernel_init="he_normal", dtype=dtype)
        self.even = k % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.even:
            y = y[:, :-1]
        return F.gelu(y)


class HubertModel(nn.Module):
    """wav [B, T] (+ optional [B, T/320] frame mask) -> [B, T/320, hidden]."""

    def __init__(self, cfg: HubertConfig = HUBERT_BASE, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg
        self.feature_extractor = ConvFeatureExtractor(c, dtype=dtype)
        self.feat_ln = LayerNorm(c.conv_layers[-1][0], c.layer_norm_eps, dtype=dtype)
        self.post_extract_proj = Linear(c.conv_layers[-1][0], c.hidden_size, dtype=dtype)
        self.pos_conv = PositionalConvEmbedding(c, dtype=dtype)
        self.encoder_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype=dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(c, dtype=dtype))

    def forward(self, wav: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("hubert.features"):  # the conv extractor, its norm and projection
            feats = self.feat_ln(self.feature_extractor(wav))
            x = self.post_extract_proj(feats)
        with span("hubert.layers"):    # the positional conv and the layers
            x = self.encoder_ln(x + self.pos_conv(x))
            for i in range(self.cfg.num_layers):
                x = getattr(self, f"layer_{i}")(x, frame_mask)
        return x
