"""The TTS GAN train step: generator update, then discriminator update.

Counterpart of vcvits_tpu/train/tts_step.py:make_tts_train_step. One call
of `TTSTrainStep` on a batch (text [B, T_x] ids, text_lengths [B], y_wav
[B, T] at the target rate, y_wav_lengths [B], pitch [B, T // hop] frame
F0 in Hz, 0 unvoiced, sid [B]):

1. Frozen targets: the spectrogram and log-mel of the float32 y_wav from
   ops/stft_mel.py (kernel K3, one launch); the energy target
   log1p(||spec frame||_2); the pitch target.
2. Generator: `SynthesizerTTS.forward` (WaveNet gates K5 with their
   backward, MAS M1, the decoder's differentiable path with its res blocks
   as modules, as JAX's training path runs them), both discriminators on
   the target segment, and total = s_gen + s_fm + p_gen + p_fm + kl + mel
   + dur + pitch + energy (C_DUR, C_PITCH, C_ENERGY below, the feature
   matching terms' weights 1, c_mel and c_kl from the config); the pitch loss over the shorter of the
   target's and the prediction's frames. Backward, global grad norm, AdamW.
   VITS's configuration (`model.msd_scales` 0, `model.variance_predictors`
   false) has no MSD terms and no pitch or energy terms, and its batches
   need no "pitch".
3. Discriminator: the LS-GAN loss of both discriminators on the G step's
   own output, detached (JAX's TTS step does not recompute the generator,
   unlike the conversion step), backward, grad norm, AdamW.

The casts are JAX's: y_spec goes to the compute dtype; the generated
slice's mel is taken of `o` in float32 through the plain path (K3 takes no
gradient); the discriminators see the target segment in the compute
dtype; losses, parameters, gradients and AdamW are float32. The SDP runs
in float32 in either dtype. With `accumulate_grad_batches` k > 1 each call
is a mini-step, as in train/step.py.

Draws: `TTSStepDraws` injects the posterior noise, the SDP's e_q and the
segment starts (tests inject JAX's); the rest comes from the step's
generators. `dropout=False` runs the forward without dropout (the JAX step
always drops out; the tests and the card-vs-CPU check turn it off on both
sides). The metrics dict has the JAX step's keys, as 0-dim float32 tensors.

Data parallelism only, as in JAX (a `Mesh` with model 1): each rank's
batch is its rows of the global batch, every loss is the global batch's
(the duration loss and the KL divide by the global mask sums), every
rank draws the global batch's noise, segment starts and dropout masks
and keeps its rows, and MAS runs per row. Each call is the program span
"vcvits.train.step" with one span a section ("targets", "g_forward",
"g_losses", "g_backward", "g_optimizer", "d_forward", "d_backward",
"d_optimizer"). train/step.py's module docstring has the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS
from vcvits_tpu_torch.ops.stft_mel import spectrogram_mel
from vcvits_tpu_torch.parallel.mesh import Mesh
from vcvits_tpu_torch.train.losses import kl_loss
from vcvits_tpu_torch.train.state import accumulate_and_step
from vcvits_tpu_torch.train.step import GANStep, _Sections, check_step_config
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.masking import slice_segments

Batch = Mapping[str, torch.Tensor]

# the loss weights beyond c_mel / c_kl (vcvits_tpu/train/tts_step.py)
C_DUR = 1.0
C_PITCH = 0.1
C_ENERGY = 0.1


@dataclass
class TTSStepDraws:
    """Injected draws of one step; None draws from the step's generator.
    eps: posterior noise [B, T_spec, inter]; e_q: the SDP's noise [B, T_x,
    2]; ids_str: segment starts [B] in spectrogram frames."""

    eps: Optional[torch.Tensor] = None
    e_q: Optional[torch.Tensor] = None
    ids_str: Optional[torch.Tensor] = None


class TTSTrainStep(GANStep):
    """SynthesizerTTS, the discriminators, their optimizers and the step.

    Builds on `device` ("cuda" by default; raises when no GPU is present
    unless device="cpu"), with seeded weights or `g_state` / `d_state`
    (for example params_from_jax / disc_params_from_jax of JAX's trees).
    The discriminators, optimizers, schedule, step counts, accumulator and
    checkpoint layout are train/step.py's `GANStep`."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 0,
                 g_state: Optional[Mapping[str, torch.Tensor]] = None,
                 d_state: Optional[Mapping[str, torch.Tensor]] = None,
                 steps_per_epoch: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 n_vocab: Optional[int] = None, dropout: bool = True,
                 mesh: Optional[Mesh] = None):
        device = resolve_device(device)
        check_step_config(cfg, dtype)
        if mesh is not None and mesh.model > 1:
            raise ValueError("the TTS step is data-parallel only (model 1), as in JAX")
        gen = SynthesizerTTS.from_config(cfg, dtype=dtype, device=device,
                                         seed=seed if g_state is None else None,
                                         n_vocab=n_vocab)
        if g_state is not None:
            gen.load_state_dict(g_state)
        self.dropout = dropout
        super().__init__(cfg, device, dtype, gen, gen.parameters(), d_state, seed,
                         steps_per_epoch, mesh)

    def _targets(self, batch: Batch):
        """(y_spec in the compute dtype, y_mel, energy target, pitch target),
        frozen: K3 on the float32 wave; the last two None without variance
        predictors."""
        d = self.cfg.data
        with torch.no_grad():
            y_spec, y_mel = spectrogram_mel(batch["y_wav"], d.filter_length, d.n_mel_channels,
                                            d.target_sampling_rate, d.hop_length, d.win_length,
                                            d.mel_fmin, d.mel_fmax)
            energy = torch.log1p(torch.linalg.vector_norm(y_spec, dim=-1))[..., None] \
                if self.gen.variance_predictors else None
        pitch = batch["pitch"][..., None].float() if self.gen.variance_predictors else None
        return y_spec.to(self.dtype), y_mel, energy, pitch

    Draws = TTSStepDraws

    def _step(self, batch: Batch, draws: TTSStepDraws, sections: _Sections
              ) -> Dict[str, torch.Tensor]:
        """The sections of one step on a batch of padded tensors on the
        step's device -> the G and D metrics (`GANStep.__call__` runs them)."""
        sections.begin("targets", "targets (K3)")
        targets = self._targets(batch)
        g_metrics, o, ids = self._generator_step(batch, targets, draws, sections)
        d_metrics = self._discriminator_step(batch, o, ids, sections)
        sections.end()
        return {**g_metrics, **d_metrics}

    def _generator_step(self, batch: Batch, targets, draws: TTSStepDraws,
                        sections: _Sections):
        cfg, t = self.cfg, self.cfg.train
        hop = cfg.data.hop_length
        y_spec, y_mel, energy_tgt, pitch_tgt = targets
        self.disc.requires_grad_(False)
        sections.begin("g_forward",
                       "G forward (text encoder, posterior, flow, MAS, SDP, decoder)")
        b, y_lengths = y_spec.shape[0], batch["y_wav_lengths"] // hop
        # on a data mesh: this rank's rows of the global batch's draws, in
        # the model's order (posterior, SDP, segment starts)
        eps = self._global_noise(draws.eps, b, (y_spec.shape[1], cfg.model.inter_channels),
                                 self.dtype)
        e_q = self._global_noise(draws.e_q, b, (batch["text"].shape[1], 2), torch.float32)
        ids_str = self._global_starts(draws.ids_str, y_lengths, self.gen.segment_size)
        mask_sum = self._mask_sum if self.mesh.data > 1 else None
        with self._dropout_rows(b):
            (o, l_length, pitch_pred, energy_pred, _, ids, _, y_mask,
             (_, z_p, m_p, logs_p, _, logs_q)) = self.gen(
                batch["text"], batch["text_lengths"], y_spec, y_lengths, batch.get("sid"),
                deterministic=not self.dropout, eps=eps, e_q=e_q, ids_str=ids_str,
                generator=self.generator, dropout_generator=self.dropout_generator,
                mask_sum=mask_sum)
        sections.begin("g_losses",
                       "G losses (MPD + MSD forward, mel, KL, duration, pitch, energy)")
        y_seg = self._target_segment(batch, ids)
        adv, adv_metrics = self._adversarial_g(self.disc(y_seg, o))
        share = self._share
        o_mel = self._mel_of(o[:, :, 0].float())
        y_mel_slice = slice_segments(y_mel, ids, t.segment_size // hop)
        loss_mel = share(torch.mean(torch.abs(o_mel - y_mel_slice))) * t.c_mel
        loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, y_mask, mask_sum) * t.c_kl
        # l_length is already over the global sum(x_mask): a sum of shares
        loss_dur = torch.sum(l_length.float()) * C_DUR
        loss_g = adv + loss_kl + loss_mel + loss_dur
        metrics = {**adv_metrics, "loss/g/mel": loss_mel, "loss/g/kl": loss_kl,
                   "loss/g/dur": loss_dur}
        if pitch_pred is not None:
            n = min(pitch_tgt.shape[1], pitch_pred.shape[1])
            ym32 = y_mask.float()
            loss_pitch = share(torch.mean(((pitch_pred[:, :n] - pitch_tgt[:, :n]) ** 2)
                                          * ym32[:, :n])) * C_PITCH
            loss_energy = share(torch.mean(((energy_pred - energy_tgt.to(energy_pred.dtype))
                                            ** 2) * ym32)) * C_ENERGY
            loss_g = loss_g + loss_pitch + loss_energy
            metrics.update({"loss/g/pitch": loss_pitch, "loss/g/energy": loss_energy})
        sections.begin("g_backward", "G backward")
        self.g_opt.zero_grad(set_to_none=True)
        loss_g.backward()
        sections.begin("g_optimizer", "G grad norm + AdamW")
        self.disc.requires_grad_(True)
        grad_norm_g = self._sum_and_norm(self.g_params)
        accumulate_and_step(self.g_opt, self.g_acc, self.mini_step, t.grad_clip)
        return {"loss/g/total": loss_g, "grad_norm_g": grad_norm_g, **metrics}, o, ids

    def _discriminator_step(self, batch: Batch, o: torch.Tensor, ids: torch.Tensor,
                            sections: _Sections) -> Dict[str, torch.Tensor]:
        """The LS-GAN D update on the G step's output, detached."""
        sections.begin("d_forward", "D forward + loss")
        y_seg = self._target_segment(batch, ids)
        loss_d, metrics = self._adversarial_d(self.disc(y_seg, o.detach()))
        sections.begin("d_backward", "D backward")
        self.d_opt.zero_grad(set_to_none=True)
        loss_d.backward()
        sections.begin("d_optimizer", "D grad norm + AdamW")
        grad_norm_d = self._sum_and_norm(self.d_params)
        accumulate_and_step(self.d_opt, self.d_acc, self.mini_step, self.cfg.train.grad_clip)
        return {"loss/d/total": loss_d, "grad_norm_d": grad_norm_d, **metrics}
