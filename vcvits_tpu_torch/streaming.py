"""Streaming chunked 48 kHz voice conversion on the GPU.

Counterpart of vcvits_tpu/streaming.py:StreamingConverter.

Windowed mode (the default):
* source audio arrives in pieces of any size; a buffer cuts it into fixed
  chunks;
* each chunk is converted inside a window [left ctx | chunk | right ctx]
  by `VoiceConverter.convert_array` (K2 for the flow reverse, K1 for the
  decoder's MRF), so HuBERT, the relative attention and the decoder's
  halo see real context; only the centre is emitted;
* consecutive emissions are equal-power cross-faded over `crossfade_ms`;
* pitch (pYIN) runs on the host per window.
The latency is chunk + right context (2.16 s by default).

`incremental=True` streams the flow reverse + decoder exactly with cached
conv state (streaming_conv.py: per-layer buffers instead of a left-context
recompute, no crossfade). Only the content encoder stays windowed (its
attention is global). The prior noise is drawn per GLOBAL frame index,
keyed on (rng_seed, frame) by a counter-based draw of the port's own
(`_frame_noise`), so the z_p stream does not depend on how the audio was
chunked. (The JAX package keys threefry the same way; its numbers cannot
be made in PyTorch, so the two agree at noise_scale=0.)
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from vcvits_tpu_torch.data.collate import alignment_unit
from vcvits_tpu_torch.dsp.pitch import coarse_f0, estimate_pitch
from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.streaming_conv import StreamingFlowDecoder
from vcvits_tpu_torch.utils.masking import nearest_interp


def _frame_noise(seed: int, start: int, n: int, channels: int) -> np.ndarray:
    """[n, channels] float32 standard normals for global frames start ..
    start + n - 1: frame f's row is drawn from its own generator, seeded
    with (seed, f), so a frame's noise is the same however the stream was
    chunked."""
    seed = int(seed) % 2 ** 64
    return np.stack([np.random.default_rng([seed, start + i])
                     .standard_normal(channels, dtype=np.float32) for i in range(n)])


class StreamingConverter:
    def __init__(self, converter: VoiceConverter, speaker_id: int, chunk_seconds: float = 2.0,
                 context_seconds: float = 0.16, crossfade_ms: float = 20.0,
                 noise_scale: float = 1.0, rng_seed: int = 0, incremental: bool = False):
        self.vc = converter
        self.sid = speaker_id
        self.noise_scale = noise_scale
        self.rng_seed = rng_seed
        cfg = converter.cfg.data
        self.src_sr = cfg.source_sampling_rate
        self.tgt_sr = cfg.target_sampling_rate
        self.ratio = self.tgt_sr // self.src_sr

        unit = alignment_unit(cfg)
        self.chunk = max(unit, int(round(chunk_seconds * self.src_sr / unit)) * unit)
        if incremental:
            # the incremental encoder slices m_p at ctx's frame offset, so
            # ctx must be a whole number of spec frames -> unit-aligned
            self.ctx = max(unit, int(round(context_seconds * self.src_sr / unit)) * unit)
        else:
            # windowed mode: the emit offset is sample-granular; only the
            # whole window (ctx + chunk + ctx) must stay unit-aligned and
            # ctx must hold whole pitch frames (hubert_downsample), so a
            # right context below one unit (e.g. chunk 0.16 s + ctx 0.08 s)
            # is expressible
            ds = cfg.hubert_downsample
            ctx = max(ds, int(round(context_seconds * self.src_sr / ds)) * ds)
            while (self.chunk + 2 * ctx) % unit:
                ctx += ds
            self.ctx = ctx
        self.xfade = int(crossfade_ms / 1000.0 * self.tgt_sr)

        self._buf = np.zeros(0, np.float32)
        self._left = np.zeros(self.ctx, np.float32)  # left context (zeros at start)
        self._tail: Optional[np.ndarray] = None  # pending crossfade tail at 48 kHz
        self._chunk_index = 0

        self.incremental = incremental
        if incremental:
            self._init_incremental()

    # ------------------------------------------------- incremental machinery
    def _frames(self, samples: int) -> int:
        """Source samples -> spec frames (exact at alignment-unit multiples)."""
        return samples * self.tgt_sr // (self.src_sr * self.vc.cfg.data.hop_length)

    def _speaker_vector(self) -> Optional[torch.Tensor]:
        gen = self.vc.gen
        if gen.emb_g is None or self.vc.cfg.model.gin_channels <= 0:
            return None
        return gen.emb_g.weight.detach()[self.sid][None, :]

    def _init_incremental(self) -> None:
        gen = self.vc.gen
        self._F = self._frames(self.chunk)          # z_p frames a chunk
        self._ctx_frames = self._frames(self.ctx)
        self._sfd = StreamingFlowDecoder(self.vc.cfg.model, self._F, dtype=gen.dtype).bind(gen)
        self._dec_state = self._sfd.init_state()
        self._frames_in = 0      # z_p frames fed so far
        self._src_true = 0       # true (un-padded) source samples pushed
        self._drop = self._sfd.delay_samples  # warm-up samples to discard
        self._g = self._speaker_vector()

    @torch.no_grad()
    def _encode(self, window: np.ndarray, pitch: np.ndarray):
        """The content encoder on one window -> (m_p, logs_p) at the
        window's output frames."""
        dev = self.vc.device
        hop = self.vc.cfg.data.hop_length
        w = torch.as_tensor(window, dtype=torch.float32, device=dev)[None, :]
        _, m_p, logs_p, _ = self.vc.gen.enc_p(
            w, torch.tensor([len(window)], dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(pitch), dtype=torch.int64, device=dev)[None, :])
        t_out = w.shape[1] * self.tgt_sr // (self.src_sr * hop)
        return nearest_interp(m_p, t_out), nearest_interp(logs_p, t_out)

    def _convert_chunk_incremental(self, window: np.ndarray,
                                   total_frames: Optional[int]) -> np.ndarray:
        """[left ctx | chunk | right ctx] source -> the chunk's converted
        samples, continuing the cached flow/decoder state exactly."""
        d = self.vc.cfg.data
        f0 = estimate_pitch(window, sr=self.src_sr, n_fft=d.filter_length,
                            win_length=d.win_length, hop_length=320)
        pitch = coarse_f0(f0, f0_bin=d.num_pitch)
        m_p, logs_p = self._encode(window, pitch)
        sl = self._ctx_frames
        m_c = m_p[:, sl: sl + self._F]
        logs_c = logs_p[:, sl: sl + self._F]
        eps = torch.from_numpy(_frame_noise(self.rng_seed, self._frames_in, self._F,
                                            m_c.shape[-1])).to(m_c.device)[None]
        z_p = m_c + eps.to(m_c.dtype) * torch.exp(logs_c) * self.noise_scale
        y, self._dec_state = self._sfd.step(self._dec_state, z_p, self._g,
                                            total_frames=total_frames)
        self._frames_in += self._F
        piece = y[0, :, 0].float().cpu().numpy()
        drop = min(self._drop, len(piece))
        self._drop -= drop
        return piece[drop:]

    # ----------------------------------------------------------------- core
    def _convert_window(self, window: np.ndarray, emit_src_len: int) -> np.ndarray:
        """Convert [ctx | emit | ctx] (16 kHz); return the emit region at 48
        kHz extended `xfade` samples into the left context's rendering (that
        span was also rendered at the END of the previous window; the two
        are cross-faded in _emit)."""
        d = self.vc.cfg.data
        f0 = estimate_pitch(window, sr=self.src_sr, n_fft=d.filter_length,
                            win_length=d.win_length, hop_length=320)
        pitch = coarse_f0(f0, f0_bin=d.num_pitch)
        out = self.vc.convert_array(window, pitch, self.sid, true_len=len(window),
                                    noise_scale=self.noise_scale, rng_seed=self.rng_seed)
        start = self.ctx * self.ratio
        lead = min(self.xfade, start)
        return out[start - lead: start + emit_src_len * self.ratio]

    def _emit(self, piece: np.ndarray) -> Optional[np.ndarray]:
        """Overlap-crossfade `piece` (which leads with `xfade` samples of
        already-emitted time) against the held tail; hold back a new tail."""
        lead = min(self.xfade, max(len(piece) - 1, 0))
        if self._tail is not None and lead > 0:
            ramp = np.sin(0.5 * np.pi * np.linspace(0, 1, lead)) ** 2
            piece = piece.copy()
            piece[:lead] = ramp * piece[:lead] + (1 - ramp) * self._tail[-lead:]
        elif lead > 0:
            piece = piece[lead:]  # first chunk: no previous rendering
        if self.xfade > 0 and len(piece) > self.xfade:
            out, self._tail = piece[: -self.xfade], piece[-self.xfade:]
        else:
            out, self._tail = piece[:0], piece if len(piece) else None
        return out if len(out) else None

    # ------------------------------------------------------------------ api
    def push(self, samples: np.ndarray) -> Iterator[np.ndarray]:
        """Feed 16 kHz source samples; yields converted 48 kHz pieces."""
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        if self.incremental:
            self._src_true += len(np.asarray(samples))
            while len(self._buf) >= self.chunk + self.ctx:
                chunk = self._buf[: self.chunk]
                right = self._buf[self.chunk: self.chunk + self.ctx]
                window = np.concatenate([self._left, chunk, right])
                piece = self._convert_chunk_incremental(window, None)
                self._left = np.concatenate([self._left, chunk])[-self.ctx:]
                self._buf = self._buf[self.chunk:]
                self._chunk_index += 1
                if len(piece):
                    yield piece
            return
        while len(self._buf) >= self.chunk + self.ctx:
            chunk = self._buf[: self.chunk]
            right = self._buf[self.chunk: self.chunk + self.ctx]
            window = np.concatenate([self._left, chunk, right])
            # the emit region includes the crossfade overlap on the left
            piece = self._convert_window(window, self.chunk)
            self._left = np.concatenate([self._left, chunk])[-self.ctx:]
            self._buf = self._buf[self.chunk:]
            self._chunk_index += 1
            out = self._emit(piece)
            if out is not None:
                yield out

    def flush(self) -> Iterator[np.ndarray]:
        """Convert whatever remains (right-padded with silence) and finish."""
        if self.incremental:
            yield from self._flush_incremental()
            return
        while len(self._buf) > 0:
            remain = min(len(self._buf), self.chunk)
            padded = np.zeros(self.chunk + self.ctx, np.float32)
            take = self._buf[: self.chunk + self.ctx]
            padded[: len(take)] = take
            window = np.concatenate([self._left, padded])
            piece = self._convert_window(window, self.chunk)
            lead = len(piece) - self.chunk * self.ratio  # crossfade overlap
            piece = piece[: lead + remain * self.ratio]
            self._left = np.concatenate([self._left, padded[: self.chunk]])[-self.ctx:]
            self._buf = self._buf[remain:]
            out = self._emit(piece)
            if out is not None:
                yield out
        if self._tail is not None:
            tail, self._tail = self._tail, None
            yield tail

    def _flush_incremental(self) -> Iterator[np.ndarray]:
        """Render the remaining buffered source, then drain the cached-state
        pipeline with zero chunks; outputs beyond the true stream length are
        masked inside StreamingFlowDecoder (the offline right padding) and
        the emitted total is capped at floor(true_len * length_scale) * hop."""
        d = self.vc.cfg.data
        total_frames = max(self._frames(self._src_true), 1)
        target = total_frames * d.hop_length
        emitted = self._frames_in * d.hop_length - (self._sfd.delay_samples - self._drop)

        def cap(piece):
            nonlocal emitted
            take = min(len(piece), max(target - emitted, 0))
            emitted += take
            return piece[:take]

        while len(self._buf) > 0:
            remain = min(len(self._buf), self.chunk)
            padded = np.zeros(self.chunk + self.ctx, np.float32)
            take = self._buf[: self.chunk + self.ctx]
            padded[: len(take)] = take
            window = np.concatenate([self._left, padded])
            piece = cap(self._convert_chunk_incremental(window, total_frames))
            self._left = np.concatenate([self._left, padded[: self.chunk]])[-self.ctx:]
            self._buf = self._buf[remain:]
            if len(piece):
                yield piece
        zeros = torch.zeros((1, self._F, self.vc.cfg.model.inter_channels),
                            dtype=torch.float32, device=self.vc.device)
        for _ in range(self._sfd.flush_chunks()):
            if emitted >= target:
                break
            y, self._dec_state = self._sfd.step(self._dec_state, zeros, self._g,
                                                total_frames=total_frames)
            self._frames_in += self._F
            piece = y[0, :, 0].float().cpu().numpy()
            drop = min(self._drop, len(piece))
            self._drop -= drop
            piece = cap(piece[drop:])
            if len(piece):
                yield piece

    def convert_stream(self, pieces: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        for p in pieces:
            yield from self.push(p)
        yield from self.flush()

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self._left = np.zeros(self.ctx, np.float32)
        self._tail = None
        self._chunk_index = 0
        if self.incremental:
            self._dec_state = self._sfd.init_state()
            self._frames_in = 0
            self._src_true = 0
            self._drop = self._sfd.delay_samples

    def set_speaker(self, speaker_id: int) -> None:
        """Re-target a (pooled, reset) converter to another speaker: the
        windowed mode passes the speaker per window, the incremental mode
        re-reads its embedding row."""
        self.sid = int(speaker_id)
        if self.incremental:
            self._g = self._speaker_vector()
