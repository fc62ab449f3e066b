"""TTS inference API: text -> 48 kHz waveform on the GPU.

Counterpart of vcvits_tpu/infer_tts.py:TTSSynthesizer:

* `encode_text`: the text front end (vcvits_tpu_torch/text), blanks
  interspersed with `add_blank`; a text that cleans to nothing raises.
* `synthesize`: the ids zero-padded up to a multiple of `text_unit`, and the
  frame budget ceil(frames_per_token * padded * max(1, length_scale))
  unless `max_frames` is given (the budget decides the output's length, as
  in JAX, where it is a static shape); `SynthesizerTTS.infer` under
  inference_mode (the SDP sampler, the flow reverse on kernel K2 and the
  decoder on K1); the output trimmed to y_mask.sum() * hop, the frames
  counted in float32.
* `from_checkpoint`: the generator of a TTS training run's checkpoint
  (train/tts_trainer.py), with the run's config.json or `cfg=`.

The card by default ("cuda", raising where there is none), the plain path
with device="cpu"; float32 or bfloat16 compute.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from vcvits_tpu_torch.config import Config, load_config
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS
from vcvits_tpu_torch.text import intersperse, text_to_sequence
from vcvits_tpu_torch.utils.audio_io import write_wav
from vcvits_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class TTSSynthesizer:
    """Text-to-speech with a SynthesizerTTS. `text_unit` is the token
    bucket: ids are zero-padded to its next multiple, and the frame budget
    is `frames_per_token` frames a padded token."""

    def __init__(self, cfg: Config, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 dtype=torch.float32, device="cuda",
                 cleaners: Sequence[str] = ("english_cleaners",), add_blank: bool = False,
                 text_unit: int = 32, frames_per_token: int = 20, seed: int = 0):
        """Weights from `state_dict`, or the seeded initialiser when it is
        None."""
        self.cfg = cfg
        self.cleaners = tuple(cleaners)
        self.add_blank = add_blank
        self.text_unit = int(text_unit)
        self.frames_per_token = int(frames_per_token)
        self.gen = SynthesizerTTS.from_config(cfg, dtype=dtype, device=device,
                                              seed=seed if state_dict is None else None)
        if state_dict is not None:
            self.gen.load_state_dict(state_dict)
        self.gen.eval()
        self.device = next(self.gen.parameters()).device

    @classmethod
    def from_params(cls, cfg: Config, g_params: Mapping, **kwargs) -> "TTSSynthesizer":
        """From the JAX package's SynthesizerTTS parameters as numpy arrays."""
        return cls(cfg, params_from_jax(g_params, cfg), **kwargs)

    @classmethod
    def from_checkpoint(cls, workdir: str, cfg: Optional[Config] = None,
                        step: Optional[int] = None, **kwargs) -> "TTSSynthesizer":
        """The generator of the checkpoint at `step` (the latest by default)
        under `workdir`/checkpoints, with `workdir`/config.json unless `cfg`
        is given. A missing checkpoint or config.json raises
        FileNotFoundError."""
        from vcvits_tpu_torch.train.checkpoint import CheckpointManager

        kwargs["device"] = resolve_device(kwargs.get("device", "cuda"))
        mgr = CheckpointManager(os.path.join(workdir, "checkpoints"))
        step = step if step is not None else mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
        if cfg is None:
            cfg_path = os.path.join(workdir, "config.json")
            if not os.path.exists(cfg_path):
                raise FileNotFoundError(
                    f"no config.json under {workdir} and no cfg= given; pass the training "
                    "config explicitly (-c) or restore a workdir that persisted one")
            cfg = load_config(cfg_path)
        state = mgr.restore(step)
        logger.info("loaded TTS checkpoint step %d from %s", step, mgr.directory)
        return cls(cfg, state["gen"], **kwargs)

    def encode_text(self, text: str) -> np.ndarray:
        seq = text_to_sequence(text, self.cleaners)
        if self.add_blank:
            seq = intersperse(seq, 0)
        if not seq:
            raise ValueError(f"text {text!r} cleaned to an empty sequence")
        return np.asarray(seq, np.int64)

    def frame_budget(self, n_ids: int, length_scale: float = 1.0,
                     max_frames: Optional[int] = None) -> int:
        """The decoder frames of a text of `n_ids` ids."""
        padded = int(np.ceil(n_ids / self.text_unit) * self.text_unit)
        if max_frames is not None:
            return int(max_frames)
        return int(np.ceil(self.frames_per_token * padded * max(1.0, length_scale)))

    def synthesize(self, text: str, sid: int = 0, noise_scale: float = 1.0,
                   length_scale: float = 1.0, noise_scale_w: float = 1.0, seed: int = 0,
                   max_frames: Optional[int] = None, return_alignment: bool = False,
                   noise_w: Optional[np.ndarray] = None, eps: Optional[np.ndarray] = None):
        """One utterance -> float32 wav at the target rate (and the
        alignment [frames, padded ids] with `return_alignment`). The draws
        come from a generator seeded with `seed`; `noise_w` [1, padded, 2]
        and `eps` [1, budget, inter] replace them."""
        seq = self.encode_text(text)
        n = len(seq)
        padded = int(np.ceil(n / self.text_unit) * self.text_unit)
        x = np.zeros((1, padded), np.int64)
        x[0, :n] = seq
        dev = self.device

        def tensor(a):
            return None if a is None else torch.as_tensor(np.asarray(a), device=dev)

        with torch.inference_mode():
            o, attn, y_mask, _ = self.gen.infer(
                torch.as_tensor(x, device=dev), torch.tensor([n], dtype=torch.int32, device=dev),
                torch.tensor([sid], dtype=torch.int64, device=dev),
                noise_scale=float(noise_scale), length_scale=float(length_scale),
                noise_scale_w=float(noise_scale_w),
                max_frames=self.frame_budget(n, length_scale, max_frames),
                generator=torch.Generator(device=dev).manual_seed(seed),
                noise_w=tensor(noise_w), eps=tensor(eps))
            # count in float32: a bf16 sum of more than 256 ones rounds
            n_valid = int(y_mask[0].float().sum().item()) * self.cfg.data.hop_length
            wav = o[0, :n_valid, 0].float().cpu().numpy()
            if return_alignment:
                return wav, attn[0].float().cpu().numpy()
        return wav

    def synthesize_to_file(self, text: str, path: str, subtype: str = "PCM_24",
                           **kwargs) -> str:
        wav = self.synthesize(text, **kwargs)
        sr = self.cfg.data.target_sampling_rate
        write_wav(path, wav, sr, subtype=subtype)
        logger.info("wrote %s (%.2f s)", path, len(wav) / sr)
        return path
