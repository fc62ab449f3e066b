"""HuBERT content-feature extractor (frozen), PyTorch.

Counterpart of vcvits_tpu/models/hubert.py: a 7-layer strided conv front
end (320x downsample, no conv bias, a per-channel GroupNorm on conv 0, exact
erf-GELU), `feat_ln` -> `post_extract_proj`, a grouped positional conv
(k=128, 16 groups, padded 64 each side, last frame dropped), `encoder_ln`,
then post-LN transformer layers. Under tensor parallelism attention is
column-parallel on q/k/v (each rank its contiguous heads) and row-parallel
on out_proj, the FFN column-parallel on fc1 and row-parallel on fc2, and
the grouped positional conv computes whole groups per rank and gathers
its channels (models/layers.py). The JAX package's im2col of conv 0 is a
TPU lane rewrite of the same conv and is not carried over.

The dense layers run on kernel G1 (ops/hubert_gemm.py) where its dispatch
rule holds (`hubert_gemm.engages`: float32 on a CUDA device, autocast off,
no tensor parallelism, nothing to differentiate, widths G1 takes): an
encoder layer then makes four launches, q/k/v as one product over the
concatenated [3C, C] weight written as [B*T, 3C] (q, k and v are views of
it), out_proj and fc2 with the bias and the residual in the epilogue, fc1
with the bias and the exact erf-GELU; post_extract_proj is one more. The
split weights are cached (`FoldCache.folded`). Everything else, and every
other case, is plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.models.layers import Conv1d, FoldCache, LayerNorm, Linear
from vcvits_tpu_torch.ops import hubert_gemm
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
        self.head_dim = hidden // heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Linear(hidden, hidden, dtype=dtype))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        return self.out_proj(self.attend(q, k, v, mask))

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Softmax attention of q, k, v [B, T, h * d] -> [B, T, h * d]; under
        tensor parallelism they hold this rank's contiguous heads."""
        b, t, _ = q.shape
        d = self.head_dim
        h = q.shape[-1] // d

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        scores = torch.matmul(q / d ** 0.5, k.transpose(-1, -2))
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :] == 0,
                                        torch.finfo(torch.float32).min)
        p = torch.softmax(scores, dim=-1)
        return torch.matmul(p, v).transpose(1, 2).reshape(b, t, h * d)

    def attend_rows(self, qkv: torch.Tensor, b: int, t: int,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
        """attend on q, k, v packed as G1's [B*T, 3C] rows -> [B*T, C], as
        batched products over B * heads (views of the rows when B == 1):
        the same operations in fewer host calls. On an H100 machine's host
        it takes 114 us a call at XTRALARGE's 177 rows where `attend` on
        views of the rows takes 149 (142 and 154 at 425 rows), about 2 ms
        of a 48-layer request that the host paces."""
        d = self.head_dim
        h = qkv.shape[1] // (3 * d)
        q, k, v = (y.reshape(b * h, t, d)
                   for y in qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        scores = torch.bmm(q / d ** 0.5, k.transpose(1, 2))
        if mask is not None:
            scores = scores.view(b, h, t, t).masked_fill(
                mask[:, None, None, :] == 0, torch.finfo(torch.float32).min).view(b * h, t, t)
        p = torch.softmax(scores, dim=-1)
        return torch.bmm(p, v).view(b, h, t, d).transpose(1, 2).reshape(b * t, h * d)


class EncoderLayer(FoldCache):
    """Post-LN transformer block (fairseq base, layer_norm_first=False)."""

    def __init__(self, cfg: HubertConfig, dtype=torch.float32):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn = SelfAttention(h, cfg.num_heads, dtype=dtype)
        self.ln1 = LayerNorm(h, eps, dtype=dtype)
        self.fc1 = Linear(h, cfg.intermediate_size, dtype=dtype)
        self.fc2 = Linear(cfg.intermediate_size, h, dtype=dtype)
        self.ln2 = LayerNorm(h, eps, dtype=dtype)
        a = self.attn
        self._dense = (a.q_proj, a.k_proj, a.v_proj, a.out_proj, self.fc1, self.fc2)
        self._g1_widths = all(hubert_gemm.takes(*m.weight.shape) for m in self._dense)

    def _dense_params(self):
        return (p for m in self._dense for p in (m.weight, m.bias))

    def on_g1(self, x: torch.Tensor) -> bool:
        """Whether this layer's dense products run on G1 for input x."""
        return hubert_gemm.engages(x, self._dense, self._g1_widths)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        if self.on_g1(x):
            return self.forward_g1(x, mask)
        x = self.ln1(x + self.attn(x, mask))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x + h)

    def _g1_weights(self):
        a = self.attn
        qkv = torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight])
        return (hubert_gemm.prepare(qkv),
                torch.cat([a.q_proj.bias, a.k_proj.bias, a.v_proj.bias]).detach(),
                hubert_gemm.prepare(a.out_proj.weight), hubert_gemm.prepare(self.fc1.weight),
                hubert_gemm.prepare(self.fc2.weight))

    def forward_g1(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """forward with the dense products as four `hubert_gemm.run` calls on
        [B*T, C] rows (G1 on a CUDA device, its plain version on the CPU),
        whose operands the rule and the layer's own shapes vouch for. The
        host's work is the price of every launch here, so the LayerNorms
        are called directly (fp32: no casts)."""
        w_qkv, b_qkv, w_out, w_fc1, w_fc2 = self.folded(self._g1_weights, self._dense_params())
        b, t, c = x.shape
        run, ln1, ln2 = hubert_gemm.run, self.ln1, self.ln2
        rows = x.reshape(b * t, c)
        att = self.attn.attend_rows(run(rows, w_qkv, b_qkv, "bias", None), b, t, mask)
        rows = torch.layer_norm(run(att, w_out, self.attn.out_proj.bias, "residual", rows), (c,),
                                ln1.weight, ln1.bias, ln1.eps)
        h = run(run(rows, w_fc1, self.fc1.bias, "gelu", None), w_fc2, self.fc2.bias, "residual",
                rows)
        return torch.layer_norm(h, (c,), ln2.weight, ln2.bias, ln2.eps).reshape(b, t, c)


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


class HubertModel(FoldCache):
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
            x = self.project(feats)
        with span("hubert.layers"):    # the positional conv and the layers
            x = self.encoder_ln(x + self.pos_conv(x))
            for i in range(self.cfg.num_layers):
                x = getattr(self, f"layer_{i}")(x, frame_mask)
        return x

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        """post_extract_proj: on G1 (bias epilogue) where its rule holds, its
        split cached here."""
        lin = self.post_extract_proj
        if not hubert_gemm.engages(feats, (lin,), hubert_gemm.takes(*lin.weight.shape)):
            return lin(feats)
        b, t, c = feats.shape
        w = self.folded(lambda: hubert_gemm.prepare(lin.weight), (lin.weight,))
        return hubert_gemm.dense(feats.reshape(b * t, c), w, lin.bias).reshape(b, t, w.n)
