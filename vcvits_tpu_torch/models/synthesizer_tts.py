"""SynthesizerTTS: the VITS text-to-speech generator, PyTorch.

Counterpart of vcvits_tpu/models/synthesizer_tts.py:SynthesizerTTS:

* `forward` (training): the text prior (models/text_encoder.py), the
  posterior and the flow forward (their WaveNet gates are kernel K5), the
  negative cross-entropy of z_p under each text position's Gaussian
  (`neg_cent`, float32, no gradient; plain matmuls, which JAX leaves to
  XLA), monotonic alignment search on it (ops/monotonic_align.py, kernel
  M1 on the card), the stochastic duration predictor's NLL of the aligned
  durations over the mask's sum, the pitch and energy predictions from z,
  the prior expanded to the frames by the alignment, and a random segment
  of z through the decoder's differentiable path (fused_mrf=False).
* `infer`: durations sampled by the SDP (exp, mask, `length_scale`, ceil),
  JAX's static frame budget t_out = max_frames or 20 T_x with y_lengths =
  clip(sum ceil(w), 1, t_out), the hard alignment of `generate_path`, the
  prior noise, the flow reverse (K2) and the decoder (K1).
* `voice_conversion`: the flow swap of the conversion path (posterior as
  K2's WaveNet mode, flow forward K2, reverse K2, decoder K1).

Random draws are explicit: injected (tests inject JAX's) or drawn from a
`generator`; dropout draws from `dropout_generator`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.models.flow import ResidualCouplingBlock
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
from vcvits_tpu_torch.models.layers import Embedding, init_weights
from vcvits_tpu_torch.models.posterior import PosteriorEncoder
from vcvits_tpu_torch.models.predictors import StochasticDurationPredictor, VariancePredictor
from vcvits_tpu_torch.models.text_encoder import TextEncoder
from vcvits_tpu_torch.ops.monotonic_align import maximum_path
from vcvits_tpu_torch.text.symbols import symbols
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.masking import generate_path, rand_slice_segments, sequence_mask


def neg_cent(z_p: torch.Tensor, m_p: torch.Tensor, logs_p: torch.Tensor) -> torch.Tensor:
    """The log-likelihood of each frame of z_p [B, T_y, C] under each text
    position's Gaussian (m_p, logs_p [B, T_x, C]) -> [B, T_y, T_x], float32,
    in JAX's four terms."""
    zs, mp, lp = z_p.float(), m_p.float(), logs_p.float()
    s_p_sq_r = torch.exp(-2.0 * lp)
    neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - lp, dim=-1)
    neg_cent2 = torch.matmul(-0.5 * zs ** 2, s_p_sq_r.transpose(1, 2))
    neg_cent3 = torch.matmul(zs, (mp * s_p_sq_r).transpose(1, 2))
    neg_cent4 = torch.sum(-0.5 * mp ** 2 * s_p_sq_r, dim=-1)
    return neg_cent1[:, None, :] + neg_cent2 + neg_cent3 + neg_cent4[:, None, :]


class SynthesizerTTS(nn.Module):
    def __init__(self, n_vocab: int, spec_channels: int, segment_size: int,
                 inter_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, p_dropout: float,
                 resblock: str, resblock_kernel_sizes: Tuple[int, ...],
                 resblock_dilation_sizes: Tuple[Tuple[int, ...], ...],
                 upsample_rates: Tuple[int, ...], upsample_initial_channel: int,
                 upsample_kernel_sizes: Tuple[int, ...], n_speakers: int = 0,
                 gin_channels: int = 0, dtype=torch.float32,
                 device="cuda", seed: Optional[int] = 0):
        """Builds on `device` ("cuda" by default; raises when no GPU is
        present unless device="cpu"). `seed` initialises the weights as the
        JAX package's initialisers do; pass seed=None and load a state
        dict instead. `segment_size` is in spectrogram frames."""
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.n_speakers = n_speakers
        self.segment_size = segment_size
        self.enc_p = TextEncoder(n_vocab, inter_channels, hidden_channels, filter_channels,
                                 n_heads, n_layers, kernel_size, p_dropout, dtype=dtype)
        self.dec = HiFiGANGenerator(
            inter_channels, resblock, resblock_kernel_sizes, resblock_dilation_sizes,
            upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
            gin_channels=gin_channels, dtype=dtype)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels, 5, 1, 16,
                                      gin_channels=gin_channels, dtype=dtype)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1, 4,
                                          gin_channels=gin_channels, dtype=dtype)
        self.duration_predictor = StochasticDurationPredictor(
            hidden_channels, 192, 3, 0.5, 4, gin_channels=gin_channels)
        self.pitch_predictor = VariancePredictor(inter_channels, 256, 3, 0.1, dtype=dtype)
        self.energy_predictor = VariancePredictor(inter_channels, 256, 3, 0.1, dtype=dtype)
        self.emb_g = Embedding(n_speakers, gin_channels, dtype=dtype) if n_speakers >= 1 \
            else None
        if seed is not None:
            init_weights(self, seed)
        self.to(device)

    @classmethod
    def from_config(cls, cfg: Config, dtype=torch.float32, device="cuda",
                    seed: Optional[int] = 0, n_vocab: Optional[int] = None) -> "SynthesizerTTS":
        """The TTS model of `cfg` (vcvits_tpu/train/tts_step.py:
        build_tts_models): the text front end's vocabulary unless `n_vocab`
        is given, the SDP."""
        m = cfg.model
        return cls(
            n_vocab=n_vocab or len(symbols), spec_channels=cfg.data.spec_channels,
            segment_size=cfg.train.segment_size // cfg.data.hop_length,
            inter_channels=m.inter_channels, hidden_channels=m.hidden_channels,
            filter_channels=m.filter_channels, n_heads=m.n_heads, n_layers=m.n_layers,
            kernel_size=m.kernel_size, p_dropout=m.p_dropout, resblock=m.resblock,
            resblock_kernel_sizes=m.resblock_kernel_sizes,
            resblock_dilation_sizes=m.resblock_dilation_sizes,
            upsample_rates=m.upsample_rates, upsample_initial_channel=m.upsample_initial_channel,
            upsample_kernel_sizes=m.upsample_kernel_sizes, n_speakers=cfg.data.n_speakers,
            gin_channels=m.gin_channels, dtype=dtype, device=device, seed=seed)

    def _speaker(self, sid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.emb_g is not None and sid is not None:
            return self.emb_g(sid)
        return None

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, y_spec: torch.Tensor,
                y_spec_lengths: torch.Tensor, sid: Optional[torch.Tensor] = None,
                deterministic: bool = True, eps: Optional[torch.Tensor] = None,
                e_q: Optional[torch.Tensor] = None, ids_str: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None):
        """The training forward. x [B, T_x] ids, y_spec [B, T_y, F].

        `eps` [B, T_y, inter] (the posterior's noise), `e_q` [B, T_x, 2]
        (the SDP's) and `ids_str` [B] (the segment starts) replace the draws
        from `generator`. Returns (o [B, segment*hop, 1], l_length [B],
        pitch_pred, energy_pred [B, T_y, 1], attn [B, T_x, T_y], ids_slice,
        x_mask, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q)) with m_p and
        logs_p expanded to the frames (float32)."""
        h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, deterministic, dropout_generator)
        g = self._speaker(sid)
        z, m_q, logs_q, y_mask = self.enc_q(y_spec, y_spec_lengths, g=g, eps=eps,
                                            generator=generator)
        z_p = self.flow(z, y_mask, g=g)
        with torch.no_grad():
            attn = maximum_path(neg_cent(z_p, m_p, logs_p), x_lengths, y_spec_lengths)

        w = torch.sum(attn, dim=2)[..., None]  # [B, T_x, 1] durations
        l_length = self.duration_predictor(
            h, x_mask, w=w, g=g, noise=e_q, generator=generator,
            deterministic=deterministic, dropout_generator=dropout_generator)
        l_length = l_length / torch.sum(x_mask)

        pitch_pred = self.pitch_predictor(z, y_mask, deterministic, dropout_generator)
        energy_pred = self.energy_predictor(z, y_mask, deterministic, dropout_generator)
        attn_t = attn.transpose(1, 2)
        m_p_exp = torch.matmul(attn_t, m_p.float())
        logs_p_exp = torch.matmul(attn_t, logs_p.float())
        z_slice, ids_slice = rand_slice_segments(z, y_spec_lengths, self.segment_size,
                                                 generator=generator, ids_str=ids_str)
        o = self.dec(z_slice, g=g, fused_mrf=False)
        return (o, l_length, pitch_pred, energy_pred, attn, ids_slice, x_mask, y_mask,
                (z, z_p, m_p_exp, logs_p_exp, m_q, logs_q))

    @torch.no_grad()
    def infer(self, x: torch.Tensor, x_lengths: torch.Tensor, sid: Optional[torch.Tensor] = None,
              noise_scale: float = 1.0, length_scale: float = 1.0, noise_scale_w: float = 1.0,
              max_frames: Optional[int] = None, generator: Optional[torch.Generator] = None,
              noise_w: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        """x [B, T_x] ids. `noise_w` [B, T_x, 2] (the SDP sampler's) and
        `eps` [B, t_out, inter] (the prior's) replace the draws from
        `generator`. Returns (o [B, t_out*hop, 1], attn [B, t_out, T_x],
        y_mask [B, t_out, 1], (z, z_p, m_p, logs_p))."""
        h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        g = self._speaker(sid)
        logw = self.duration_predictor(h, x_mask, g=g, reverse=True, noise_scale=noise_scale_w,
                                       noise=noise_w, generator=generator)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w)[..., 0]  # [B, T_x]

        t_out = max_frames if max_frames is not None else 20 * x.shape[1]
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=1), 1, t_out).to(torch.int32)
        y_mask = sequence_mask(y_lengths, t_out).to(m_p.dtype)
        attn = generate_path(w_ceil.to(torch.int32), y_mask, x_mask)  # [B, T_y, T_x]

        m_p = torch.matmul(attn, m_p)
        logs_p = torch.matmul(attn, logs_p)
        if eps is None:
            eps = torch.randn(m_p.shape, generator=generator, device=m_p.device,
                              dtype=m_p.dtype)
        z_p = m_p + eps.to(m_p.device, m_p.dtype) * torch.exp(logs_p) * noise_scale
        z = self.flow.kernel_reverse(z_p, y_mask, g=g).to(z_p.dtype)
        o = self.dec(z * y_mask, g=g, fused_mrf=True)
        return o, attn, y_mask, (z, z_p, m_p, logs_p)

    @torch.no_grad()
    def voice_conversion(self, y_spec: torch.Tensor, y_spec_lengths: torch.Tensor,
                         sid_src: torch.Tensor, sid_tgt: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None):
        """The flow swap, as SynthesizerSVC.voice_conversion. Returns
        (o_hat [B, T_spec*hop, 1], y_mask, (z, z_p, z_hat))."""
        if self.emb_g is None:
            raise ValueError("voice_conversion needs speaker embeddings (n_speakers >= 1)")
        g_src, g_tgt = self.emb_g(sid_src), self.emb_g(sid_tgt)
        z, _, _, y_mask = self.enc_q(y_spec, y_spec_lengths, g=g_src, eps=eps,
                                     generator=generator, fused_wn=True)
        z_p = self.flow.kernel_forward(z, y_mask, g=g_src)
        z_hat = self.flow.kernel_reverse(z_p, y_mask, g=g_tgt).to(z_p.dtype)
        o_hat = self.dec(z_hat * y_mask, g=g_tgt, fused_mrf=True)
        return o_hat, y_mask, (z, z_p, z_hat)
