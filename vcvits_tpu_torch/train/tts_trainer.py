"""The TTS training loop (the port's counterpart of
vcvits_tpu/train/tts_trainer.py): bucketed (text, audio, F0) batches,
`TTSTrainStep`, TensorBoard scalars, checkpoints and validation.

`TTSTrainer.fit` pads every batch to `text_bucket` ids and `audio_seconds`
of audio (collate_tts, on a background thread), resumes from the latest
checkpoint of its workdir (the port's CheckpointManager, shape-tolerant),
and steps until `max_steps` or cfg.train.max_epochs, logging every
`log_interval` steps (with steps/s, an EMA of the step's wall time from
utils/profiling.py's `StepTimer`, as JAX's), synthesizing the first training sentence every
`eval_interval` (`log_validation`, whose failure is logged and never ends
training) and checkpointing every `checkpoint_interval`. It writes
config.json into the workdir, which `TTSSynthesizer.from_checkpoint`
reads.

Behaviours mirrored from the JAX trainer as they are: each epoch's order
and crops come from random.Random(seed + epoch), so after a resume the
epoch loop starts again at epoch 0; no random state is checkpointed (every
fit reseeds the step's generators from cfg.train.seed); the schedule's
epoch is the config's steps_per_epoch (1000 where unset), not the
loader's length.

Under torch.distributed the trainer is data-parallel only, as JAX's
(`training_mesh(batch_size, 1)`): each rank collates its rows of every
global batch, the step keeps the global batch's losses, rank 0 writes
config.json, TensorBoard, the checkpoints and the validation, and every
rank restores.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Optional, Sequence

import numpy as np
import torch

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data.loader import prefetch, shard_rows, to_device
from vcvits_tpu_torch.data.tts_dataset import TTSDataset, collate_tts
from vcvits_tpu_torch.ops.stft_mel import mel_spectrogram
from vcvits_tpu_torch.parallel.mesh import training_mesh
from vcvits_tpu_torch.text import intersperse, text_to_sequence
from vcvits_tpu_torch.train.checkpoint import CheckpointManager
from vcvits_tpu_torch.train.trainer import NullLogger
from vcvits_tpu_torch.train.tts_step import TTSTrainStep
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.logging import TensorBoardLogger, alignment_to_image, mel_to_image
from vcvits_tpu_torch.utils.profiling import StepTimer

logger = logging.getLogger(__name__)


class TTSTrainer:
    def __init__(self, cfg: Config, workdir: str = "logs_tts", device="cuda",
                 dtype: torch.dtype = torch.float32, text_bucket: int = 192,
                 audio_seconds: float = 8.0, cleaners: Sequence[str] = ("english_cleaners",),
                 add_blank: bool = False):
        """A trainer on `device` ("cuda" by default; raises when no GPU is
        present unless device="cpu") in the compute dtype `dtype`; under
        torch.distributed, one data rank of `training_mesh`."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.workdir = workdir
        self.dtype = dtype
        self.text_bucket = text_bucket
        self.audio_bucket = int(audio_seconds * cfg.data.target_sampling_rate)
        self.cleaners = tuple(cleaners)
        self.add_blank = add_blank
        self.mesh = training_mesh(cfg.train.batch_size, 1)
        if self.mesh.is_main:
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=1)
        self.tb = TensorBoardLogger(os.path.join(workdir, "tb")) if self.mesh.is_main \
            else NullLogger()
        self.ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
        self.train_step = TTSTrainStep(cfg, device=self.device, seed=cfg.train.seed,
                                       dtype=dtype, mesh=self.mesh) if self.mesh.active \
            else None

    def _batches(self, ds: TTSDataset, epoch: int):
        rng = random.Random(self.cfg.train.seed + epoch)
        order = list(range(len(ds)))
        rng.shuffle(order)
        bsz = self.cfg.train.batch_size
        rows = shard_rows(bsz, (self.mesh.data_rank, self.mesh.data))
        for i in range(0, len(order) - bsz + 1, bsz):
            items = [ds.get_item(j) for j in order[i:i + bsz]]
            yield collate_tts(items, self.cfg.data, self.text_bucket, self.audio_bucket, rng,
                              rows)

    def resume_or_init(self) -> int:
        """Restore the latest checkpoint, if there is one (shape-tolerant);
        returns the step to continue from."""
        step = self.ckpt.latest_step()
        if step is not None:
            state, changed = self.ckpt.restore_tolerant(self.train_step.state_dict(), step)
            self.train_step.load_state_dict(state)
            logger.info("resumed TTS training from step %d (tolerant=%s)", step, changed)
        return self.train_step.step

    def fit(self, train_files: str, max_steps: Optional[int] = None) -> Optional[int]:
        """Train until max_steps or cfg.train.max_epochs; returns the final
        step (None when no batch came, or on a rank the mesh leaves out)."""
        cfg = self.cfg
        if not self.mesh.active:
            logger.warning("this rank is outside the %d-rank data mesh: not training",
                           self.mesh.data)
            return None
        main = self.mesh.is_main
        ds = TTSDataset(train_files, cfg.data, cleaners=self.cleaners, add_blank=self.add_blank,
                        pitch=cfg.model.variance_predictors)
        step = self.train_step
        step.generator.manual_seed(cfg.train.seed)
        step.dropout_generator.manual_seed(cfg.train.seed + 1)
        step_no: Optional[int] = None
        timer = StepTimer()
        for epoch in range(cfg.train.max_epochs):
            for batch in prefetch(self._batches(ds, epoch)):
                if step_no is None:
                    step_no = self.resume_or_init()
                if max_steps is not None and step_no >= max_steps:
                    return self._finish(step_no)
                metrics = step(to_device(batch, self.device))
                timer.tick()
                step_no += 1
                if step_no % cfg.train.log_interval == 0 and main:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    if timer.steps_per_sec:
                        scalars["steps_per_sec"] = timer.steps_per_sec
                    self.tb.summarize(step_no, scalars=scalars)
                    logger.info("tts step %d loss_g=%.3f loss_d=%.3f dur=%.3f", step_no,
                                scalars["loss/g/total"], scalars["loss/d/total"],
                                scalars["loss/g/dur"])
                if step_no % cfg.train.eval_interval == 0 and len(ds.items) > 0 and main:
                    try:
                        self.log_validation(step_no, ds.items[0][2], sid=int(ds.items[0][1]))
                    except Exception:  # noqa: BLE001 - validation must never end training
                        logger.exception("TTS validation logging failed")
                if step_no % cfg.train.checkpoint_interval == 0 and main:
                    self.ckpt.save(step_no, step.state_dict())
        return self._finish(step_no) if step_no is not None else None

    def _finish(self, step_no: int) -> int:
        if self.mesh.is_main:
            self.ckpt.wait()
            if self.ckpt.latest_step() != step_no:
                self.ckpt.save(step_no, self.train_step.state_dict())
            self.ckpt.wait()
        # the other ranks return once rank 0's checkpoint is complete
        self.mesh.agree(False)
        self.tb.flush()
        self.tb.close()
        logger.info("TTS training finished at step %d", step_no)
        return step_no

    def synthesize(self, text: str, sid: int = 0, max_frames: int = 1024,
                   return_alignment: bool = False):
        """Text -> waveform with the current weights (a validation aid):
        `SynthesizerTTS.infer` at noise 1 with draws seeded 0, trimmed to
        its valid frames."""
        seq = text_to_sequence(text, self.cleaners)
        if self.add_blank:
            seq = intersperse(seq, 0)
        gen, dev = self.train_step.gen, self.device
        gen.eval()
        try:
            with torch.no_grad():
                o, attn, y_mask, _ = gen.infer(
                    torch.tensor([seq], dtype=torch.int64, device=dev),
                    torch.tensor([len(seq)], dtype=torch.int32, device=dev),
                    torch.tensor([sid], dtype=torch.int64, device=dev), max_frames=max_frames,
                    generator=torch.Generator(device=dev).manual_seed(0))
        finally:
            gen.train()
        # count in float32: a bf16 sum of more than 256 ones rounds
        n_valid = int(y_mask[0].float().sum().item()) * self.cfg.data.hop_length
        wav = o[0, :n_valid, 0].float().cpu().numpy()
        if return_alignment:
            return wav, attn[0].float().cpu().numpy()
        return wav

    def log_validation(self, step_no: int, text: str, sid: int = 0) -> None:
        """Synthesize `text`; log its audio, its mel image (K4) and the
        duration alignment's image."""
        d = self.cfg.data
        wav, attn = self.synthesize(text, sid=sid, return_alignment=True)
        images = {"val/alignment": alignment_to_image(attn.T)}
        t = (len(wav) // d.hop_length) * d.hop_length
        if t > 0:
            mel = mel_spectrogram(torch.as_tensor(wav[:t], device=self.device)[None],
                                  d.filter_length, d.n_mel_channels, d.target_sampling_rate,
                                  d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)
            images["val/mel"] = mel_to_image(mel[0].cpu().numpy())
        self.tb.summarize(step_no, images=images, audios={"val/audio": np.asarray(wav)},
                          audio_sampling_rate=d.target_sampling_rate)
        self.tb.flush()
