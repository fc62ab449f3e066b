"""SynthesizerSVC: the end-to-end 48 kHz conversion generator.

Counterpart of vcvits_tpu/models/synthesizer.py:SynthesizerSVC:

* `infer`: the content encoder gives (m_p, logs_p) at 50 Hz,
  nearest-interpolated to 48 kHz frames; z_p = m_p + eps * exp(logs_p) *
  noise_scale; the flow reverse (ops/flow_coupling.py, K2) gives z; the
  HiFi-GAN decoder (ops/mrf.py per stage, K1) gives the wave.
* `voice_conversion`: the flow swap. The posterior encoder (its WN as K2's
  WaveNet mode, `fused_wn`) takes the source spectrogram with the source
  speaker, the flow forward (K2's forward mode) maps z to z_p, and the
  reverse with the target speaker (K2) and the decoder (K1) give the wave.
* `forward`: the training forward. enc_p and enc_q, the flow forward, the
  prior interpolated to the spectrogram frames, a random segment of z
  through the decoder's differentiable path (fused_mrf=False).

On a CUDA device the kernels run with no flag that sends the card to the
plain path. Random draws come from explicit generators, or are injected.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.models.content_encoder import HubertContentEncoder
from vcvits_tpu_torch.models.flow import ResidualCouplingBlock
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
from vcvits_tpu_torch.models.hubert import HUBERT_BASE, HUBERT_XTRALARGE, HubertConfig
from vcvits_tpu_torch.models.layers import Embedding, init_weights
from vcvits_tpu_torch.models.posterior import PosteriorEncoder
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.masking import nearest_interp, rand_slice_segments, sequence_mask


# `infer`'s default output frames per 16 kHz source sample: 48 kHz frames of
# 512 samples
DEFAULT_LENGTH_SCALE = (48000 / 512) / 16000


def hubert_config_for(hubert_channels: int) -> HubertConfig:
    return HUBERT_XTRALARGE if hubert_channels == 1280 else HUBERT_BASE


class SynthesizerSVC(nn.Module):
    def __init__(self, inter_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, resblock: str,
                 resblock_kernel_sizes: Tuple[int, ...],
                 resblock_dilation_sizes: Tuple[Tuple[int, ...], ...],
                 upsample_rates: Tuple[int, ...], upsample_initial_channel: int,
                 upsample_kernel_sizes: Tuple[int, ...], hubert_channels: int, num_pitch: int,
                 n_speakers: int = 0, gin_channels: int = 0,
                 hubert_cfg: Optional[HubertConfig] = None,
                 dec_quant_int8: Union[bool, str] = False,
                 spec_channels: int = 1025, segment_size: int = 32, p_dropout: float = 0.0,
                 dtype=torch.float32, device="cuda", seed: Optional[int] = 0,
                 init_on_device: bool = False):
        """Builds on `device` ("cuda" by default; raises when no GPU is
        present unless device="cpu"). `seed` initialises the weights as the
        JAX package does (drawn on `device` with `init_on_device`, see
        models/layers.py:init_weights); pass seed=None and load a state
        dict instead.
        `dec_quant_int8` selects the int8 decoder (models/hifigan.py): True
        for dynamic W8A8, "w8" for weight-only; inference only."""
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.n_speakers = n_speakers
        self.segment_size = segment_size  # in spectrogram frames
        self.enc_p = HubertContentEncoder(
            hubert_cfg or hubert_config_for(hubert_channels), inter_channels, hidden_channels,
            filter_channels, n_heads, n_layers, kernel_size, num_pitch, p_dropout, dtype=dtype)
        self.dec = HiFiGANGenerator(
            inter_channels, resblock, resblock_kernel_sizes, resblock_dilation_sizes,
            upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
            gin_channels=gin_channels, quant_int8=dec_quant_int8, dtype=dtype)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1, 4,
                                          gin_channels=gin_channels, dtype=dtype)
        self.emb_g = Embedding(n_speakers, gin_channels, dtype=dtype) if n_speakers >= 1 \
            else None
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels, 5, 1, 16,
                                      gin_channels=gin_channels, dtype=dtype)
        if seed is not None and init_on_device:
            self.to(device)
            init_weights(self, seed, device=device)
        elif seed is not None:
            init_weights(self, seed)
        self.to(device)

    @classmethod
    def from_config(cls, cfg: Config, dtype=torch.float32, device="cuda",
                    seed: Optional[int] = 0, hubert_cfg: Optional[HubertConfig] = None,
                    dec_quant_int8: Union[bool, str, None] = None,
                    init_on_device: bool = False) -> "SynthesizerSVC":
        """The model of `cfg`; `dec_quant_int8`, where given, overrides the
        config's, as `VoiceConverter(quant_int8=...)` clones JAX's."""
        m = cfg.model
        return cls(
            inter_channels=m.inter_channels, hidden_channels=m.hidden_channels,
            filter_channels=m.filter_channels, n_heads=m.n_heads, n_layers=m.n_layers,
            kernel_size=m.kernel_size, resblock=m.resblock,
            resblock_kernel_sizes=m.resblock_kernel_sizes,
            resblock_dilation_sizes=m.resblock_dilation_sizes,
            upsample_rates=m.upsample_rates,
            upsample_initial_channel=m.upsample_initial_channel,
            upsample_kernel_sizes=m.upsample_kernel_sizes,
            hubert_channels=m.hubert_channels, num_pitch=m.num_pitch,
            n_speakers=cfg.data.n_speakers, gin_channels=m.gin_channels,
            hubert_cfg=hubert_cfg,
            dec_quant_int8=m.dec_quant_int8 if dec_quant_int8 is None else dec_quant_int8,
            spec_channels=cfg.data.spec_channels,
            segment_size=cfg.train.segment_size // cfg.data.hop_length,
            p_dropout=m.p_dropout, dtype=dtype, device=device, seed=seed,
            init_on_device=init_on_device)

    def _speaker(self, sid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.emb_g is not None and sid is not None:
            return self.emb_g(sid)
        return None

    def forward(self, x_wav: torch.Tensor, x_wav_lengths: torch.Tensor, x_pitch: torch.Tensor,
                y_spec: torch.Tensor, y_spec_lengths: torch.Tensor,
                sid: Optional[torch.Tensor] = None, deterministic: bool = True,
                hubert_features: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None, ids_str: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None):
        """The training forward. x_wav [B, T] 16 kHz, y_spec [B, T_spec, F].

        `eps` [B, T_spec, inter] (the posterior's noise) and `ids_str` [B]
        (the segment starts) replace the draws from `generator`; dropout
        (deterministic=False) draws from `dropout_generator`. Returns
        (y_hat [B, segment_size*hop, 1], ids_slice, x_mask, y_mask,
        (z, z_p, m_p, logs_p, m_q, logs_q)).
        """
        _, m_p, logs_p, x_mask = self.enc_p(x_wav, x_wav_lengths, x_pitch, deterministic,
                                            dropout_generator, hubert_features)
        g = self._speaker(sid)
        z, m_q, logs_q, y_mask = self.enc_q(y_spec, y_spec_lengths, g=g, eps=eps,
                                            generator=generator)
        z_p = self.flow(z, y_mask, g=g)
        t_spec = y_spec.shape[1]
        m_p = nearest_interp(m_p, t_spec)
        logs_p = nearest_interp(logs_p, t_spec)
        z_slice, ids_slice = rand_slice_segments(z, y_spec_lengths, self.segment_size,
                                                 generator=generator, ids_str=ids_str)
        o = self.dec(z_slice, g=g, fused_mrf=False)
        return o, ids_slice, x_mask, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q)

    @torch.no_grad()
    def infer(self, x_wav: torch.Tensor, x_wav_lengths: torch.Tensor, x_pitch: torch.Tensor,
              sid: Optional[torch.Tensor] = None, noise_scale: float = 1.0,
              length_scale: float = DEFAULT_LENGTH_SCALE, max_len: Optional[int] = None,
              generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        """x_wav [B, T] 16 kHz, x_wav_lengths [B], x_pitch [B, T//320].

        Output length t_out = round(T_wav * length_scale) frames, per-row
        validity in y_mask. `eps` [B, t_out, inter] replaces the normal
        draw from `generator` (tests inject JAX's draw with it).
        Returns (o [B, t_out*hop, 1], y_mask [B, t_out, 1], (z, z_p, m_p, logs_p)).
        """
        _, m_p, logs_p, _ = self.enc_p(x_wav, x_wav_lengths, x_pitch)
        g = self._speaker(sid)

        t_out = int(round(x_wav.shape[1] * length_scale))
        y_lengths = (x_wav_lengths.to(torch.float32) * length_scale).to(torch.int32)
        y_mask = sequence_mask(y_lengths, t_out).to(m_p.dtype)

        m_p = nearest_interp(m_p, t_out)
        logs_p = nearest_interp(logs_p, t_out)
        if eps is None:
            eps = torch.randn(m_p.shape, generator=generator, device=m_p.device,
                              dtype=m_p.dtype)
        z_p = m_p + eps.to(m_p.device, m_p.dtype) * torch.exp(logs_p) * noise_scale
        z = self.flow.kernel_reverse(z_p, y_mask, g=g).to(z_p.dtype) * y_mask
        if max_len is not None:
            z = z[:, :max_len]
            y_mask = y_mask[:, :max_len]
        o = self.dec(z, g=g, fused_mrf=True)
        return o, y_mask, (z, z_p, m_p, logs_p)

    @torch.no_grad()
    def voice_conversion(self, y_spec: torch.Tensor, y_spec_lengths: torch.Tensor,
                         sid_src: torch.Tensor, sid_tgt: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None):
        """Any-to-any flow swap. y_spec [B, T_spec, F] of audio by speaker
        sid_src; `eps` [B, T_spec, inter] replaces the posterior's draw.
        Returns (o_hat [B, T_spec*hop, 1], y_mask, (z, z_p, z_hat))."""
        if self.emb_g is None:
            raise ValueError("voice_conversion needs speaker embeddings (n_speakers >= 1)")
        g_src, g_tgt = self.emb_g(sid_src), self.emb_g(sid_tgt)
        z, _, _, y_mask = self.enc_q(y_spec, y_spec_lengths, g=g_src, eps=eps,
                                     generator=generator, fused_wn=True)
        z_p = self.flow.kernel_forward(z, y_mask, g=g_src)
        z_hat = self.flow.kernel_reverse(z_p, y_mask, g=g_tgt).to(z_p.dtype)
        o_hat = self.dec(z_hat * y_mask, g=g_tgt, fused_mrf=True)
        return o_hat, y_mask, (z, z_p, z_hat)
