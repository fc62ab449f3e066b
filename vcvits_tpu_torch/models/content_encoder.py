"""HuBERT content encoder with coarse-F0 conditioning (the prior encoder).

Counterpart of vcvits_tpu/models/content_encoder.py: pad the 16 kHz wav by
40 samples each side, frozen HuBERT features -> `hubert_proj`, add the
clipped pitch embedding, a relative-position transformer, then `proj`
split into (m_p, logs_p). The frame mask is `wav_len // 320`, as in JAX.
`hubert_features` (the train step's shared frozen features) skips the
HuBERT forward; dropout acts only with deterministic=False. The program
spans "vcvits.content.hubert" and "vcvits.content.prior"
(utils/profiling.py) cover the two halves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.models.attention import TransformerEncoder
from vcvits_tpu_torch.models.hubert import HubertConfig, HubertModel
from vcvits_tpu_torch.models.layers import Conv1d, Embedding, Linear
from vcvits_tpu_torch.utils.masking import sequence_mask
from vcvits_tpu_torch.utils.profiling import span

HUBERT_PAD = 40  # (receptive_field - downsample) // 2 = (400-320)//2


class HubertContentEncoder(nn.Module):
    def __init__(self, hubert_cfg: HubertConfig, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
                 num_pitch: int, p_dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.num_pitch = num_pitch
        self.dtype = dtype
        self.hubert = HubertModel(hubert_cfg, dtype=dtype)
        self.hubert_proj = Linear(hubert_cfg.hidden_size, hidden_channels, dtype=dtype)
        self.emb_pitch = Embedding(num_pitch, hidden_channels, std=hidden_channels ** -0.5,
                                   dtype=dtype)
        self.encoder = TransformerEncoder(hidden_channels, filter_channels, n_heads,
                                          n_layers, kernel_size, p_dropout, dtype=dtype)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1, dtype=dtype)

    def forward(self, x_wav: torch.Tensor, x_wav_lengths: torch.Tensor, x_pitch: torch.Tensor,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                hubert_features: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """x_wav: [B, T] 16 kHz; x_pitch: [B, T//320] int bins.

        Returns (x_out, m_p, logs_p, x_mask) on the 50 Hz frame axis."""
        if hubert_features is None:
            with span("content.hubert"), torch.no_grad():
                feats = self.hubert(F.pad(x_wav, (HUBERT_PAD, HUBERT_PAD)))
        else:
            feats = hubert_features.detach()
        with span("content.prior"):
            h = self.hubert_proj(feats)
            t50 = h.shape[1]
            pitch = torch.clamp(x_pitch[:, :t50], 0, self.num_pitch - 1)
            h = h + self.emb_pitch(pitch)

            frame_lengths = x_wav_lengths.to(torch.int64) // 320
            x_mask = sequence_mask(frame_lengths, t50).to(h.dtype)
            x_out = self.encoder(h * x_mask, x_mask, deterministic, generator)
            stats = self.proj(x_out) * x_mask
            m = stats[..., :self.out_channels]
            logs = stats[..., self.out_channels:]
        return x_out, m, logs, x_mask
