"""Inference API: file-to-file any-to-any voice conversion on the GPU.

Counterpart of vcvits_tpu/infer.py:VoiceConverter.

* `convert`: resample the source to 16 kHz, optional semitone pitch shift,
  pYIN -> coarse F0 on the host, then `SynthesizerSVC.infer` on the device,
  and write 48 kHz PCM_24.
* `voice_conversion`: the flow swap. Resample the source to 48 kHz, take
  its spectrogram on the device (ops/stft_mel.py, kernel K3), then
  `SynthesizerSVC.voice_conversion` from the source speaker to the target,
  and write 48 kHz PCM_24.

Inputs are padded to an alignment-unit boundary, as in JAX. Each
`convert_array` and `voice_conversion_array` call is a program span
("vcvits.convert" or "vcvits.voice_conversion", with the converter's
request number; utils/profiling.py) around the spans of its phases: the
inputs to the card ("vcvits.convert.upload"), the model's own spans, and
the valid samples back to the host ("vcvits.convert.download").
`VoiceConverter.from_checkpoint` loads the generator of a training run
(train/trainer.py) from its workdir. `quant_int8` (True: dynamic W8A8, "w8":
weight-only) builds the generator with the int8 decoder, as JAX's clone
does, so every conversion decodes in that mode on the same weights.
"""

from __future__ import annotations

import itertools
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from vcvits_tpu_torch.config import Config, load_config
from vcvits_tpu_torch.convert.from_jax import params_from_jax
from vcvits_tpu_torch.data.collate import alignment_unit
from vcvits_tpu_torch.dsp.pitch import coarse_f0, estimate_pitch
from vcvits_tpu_torch.dsp.pitch_shift import pitch_shift as shift_semitones
from vcvits_tpu_torch.dsp.resample import resample
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC
from vcvits_tpu_torch.ops.stft_mel import spectrogram
from vcvits_tpu_torch.utils.audio_io import read_wav, write_wav
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class VoiceConverter:
    def __init__(self, cfg: Config, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 dtype=torch.float32, device="cuda", hubert_cfg: Optional[HubertConfig] = None,
                 seed: int = 0, quant_int8: Union[bool, str] = False):
        """A converter on `device` ("cuda" by default; raises when no GPU
        is present unless device="cpu"). Weights come from `state_dict`, or
        from the seeded initialiser when it is None. A true `quant_int8`
        overrides the config's `dec_quant_int8`."""
        self.cfg = cfg
        self.gen = SynthesizerSVC.from_config(
            cfg, dtype=dtype, device=device, seed=seed if state_dict is None else None,
            hubert_cfg=hubert_cfg, dec_quant_int8=quant_int8 or None)
        if state_dict is not None:
            self.gen.load_state_dict(state_dict)
        self.gen.eval()
        self.device = next(self.gen.parameters()).device
        self.unit = alignment_unit(cfg.data)
        self._requests = itertools.count()  # the request number of the spans

    @classmethod
    def from_params(cls, cfg: Config, g_params: Mapping, dtype=torch.float32, device="cuda",
                    hubert_cfg: Optional[HubertConfig] = None,
                    quant_int8: Union[bool, str] = False) -> "VoiceConverter":
        """From the JAX package's generator parameters as numpy arrays."""
        return cls(cfg, params_from_jax(g_params, cfg), dtype=dtype, device=device,
                   hubert_cfg=hubert_cfg, quant_int8=quant_int8)

    @classmethod
    def from_checkpoint(cls, workdir: str, cfg: Optional[Config] = None,
                        step: Optional[int] = None, dtype=torch.float32, device="cuda",
                        hubert_cfg: Optional[HubertConfig] = None,
                        quant_int8: Union[bool, str] = False) -> "VoiceConverter":
        """The generator of a training run's checkpoint at `step` (the
        latest by default) under `workdir`/checkpoints. With cfg None, the
        run's `workdir`/config.json is read (the default Config where it is
        missing)."""
        from vcvits_tpu_torch.train.checkpoint import CheckpointManager

        device = resolve_device(device)
        mgr = CheckpointManager(os.path.join(workdir, "checkpoints"))
        step = step if step is not None else mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
        state = mgr.restore(step)
        logger.info("loaded checkpoint step %d from %s", step, mgr.directory)
        if cfg is None:
            cfg_path = os.path.join(workdir, "config.json")
            cfg = load_config(cfg_path) if os.path.exists(cfg_path) else Config()
        return cls(cfg, state["gen"], dtype=dtype, device=device, hubert_cfg=hubert_cfg,
                   quant_int8=quant_int8)

    def prepare_source(self, path: str, pitch_shift: int = 0
                       ) -> Tuple[np.ndarray, int, np.ndarray]:
        """wav file -> (padded 16k source, true length, coarse pitch)."""
        d = self.cfg.data
        wav, sr = read_wav(path)
        wav = resample(wav, sr, d.source_sampling_rate)
        if pitch_shift != 0:
            wav = shift_semitones(wav, d.source_sampling_rate, pitch_shift)
        true_len = len(wav)
        padded = int(np.ceil(max(true_len, 1) / self.unit) * self.unit)
        wav = np.pad(wav, (0, padded - true_len))
        f0 = estimate_pitch(wav, sr=d.source_sampling_rate, n_fft=d.filter_length,
                            win_length=d.win_length, hop_length=320)
        pitch = coarse_f0(f0, f0_bin=d.num_pitch)
        return wav.astype(np.float32), true_len, pitch

    def convert_array(self, wav16k: np.ndarray, pitch: np.ndarray, speaker_id: int,
                      true_len: Optional[int] = None, noise_scale: float = 1.0,
                      rng_seed: int = 0, eps: Optional[np.ndarray] = None) -> np.ndarray:
        """One utterance -> the valid 48 kHz samples. `eps` [1, t_out, inter]
        replaces the seeded normal draw."""
        dev = self.device
        true_len = true_len if true_len is not None else len(wav16k)
        with span("convert", request=next(self._requests)):
            with span("convert.upload"):
                gen = torch.Generator(device=dev).manual_seed(rng_seed)
                wav = torch.as_tensor(wav16k, dtype=torch.float32, device=dev)[None, :]
                lengths = torch.tensor([true_len], dtype=torch.int32, device=dev)
                bins = torch.as_tensor(np.asarray(pitch), dtype=torch.int64, device=dev)[None, :]
                sid = torch.tensor([speaker_id], dtype=torch.int64, device=dev)
                eps = None if eps is None else torch.as_tensor(eps, device=dev)
            o, y_mask, _ = self.gen.infer(wav, lengths, bins, sid, noise_scale=noise_scale,
                                          generator=gen, eps=eps)
            with span("convert.download"):
                # count in float32: a bf16 sum of more than 256 ones rounds
                n_valid = int(y_mask[0].float().sum().item()) * self.cfg.data.hop_length
                return o[0, :n_valid, 0].float().cpu().numpy()

    def convert(self, source_audio: str, target_audio: str, speaker_id: int,
                pitch_shift: int = 0, noise_scale: float = 1.0) -> np.ndarray:
        """File -> file, PCM_24 at the target rate."""
        wav, true_len, pitch = self.prepare_source(source_audio, pitch_shift)
        out = self.convert_array(wav, pitch, speaker_id, true_len, noise_scale)
        write_wav(target_audio, out, self.cfg.data.target_sampling_rate, subtype="PCM_24")
        return out

    def convert_many(self, jobs, pitch_shift: int = 0, noise_scale: float = 1.0,
                     collect_audio: bool = False):
        """Pipelined conversion of (source_path, output_path, speaker_id)
        jobs: one worker thread prepares file i+1 on the host (read,
        resample, pYIN) while the device converts file i. Returns the output
        paths, or the waveforms with `collect_audio=True`."""
        jobs = list(jobs)
        outs = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self.prepare_source, jobs[0][0], pitch_shift) if jobs else None
            for i, (_src, dst, sid) in enumerate(jobs):
                wav, true_len, pitch = fut.result()
                if i + 1 < len(jobs):
                    fut = pool.submit(self.prepare_source, jobs[i + 1][0], pitch_shift)
                out = self.convert_array(wav, pitch, sid, true_len, noise_scale)
                write_wav(dst, out, self.cfg.data.target_sampling_rate, subtype="PCM_24")
                outs.append(out if collect_audio else dst)
        return outs

    def voice_conversion_array(self, wav48k: np.ndarray, sid_src: int, sid_tgt: int,
                               rng_seed: int = 0, eps: Optional[np.ndarray] = None
                               ) -> np.ndarray:
        """One 48 kHz utterance of speaker sid_src -> the valid 48 kHz samples
        in speaker sid_tgt's voice. `eps` [1, T_spec, inter] replaces the
        posterior's seeded normal draw."""
        d = self.cfg.data
        dev = self.device
        unit_y = self.unit * d.target_sampling_rate // d.source_sampling_rate
        true_len = len(wav48k)
        padded = int(np.ceil(max(true_len, 1) / unit_y) * unit_y)
        with span("voice_conversion", request=next(self._requests)):
            with span("convert.upload"):
                wav = torch.as_tensor(np.pad(np.asarray(wav48k, np.float32),
                                             (0, padded - true_len)), device=dev)[None, :]
                gen = torch.Generator(device=dev).manual_seed(rng_seed)
                lengths = torch.tensor([true_len // d.hop_length], dtype=torch.int32, device=dev)
                src = torch.tensor([sid_src], dtype=torch.int64, device=dev)
                tgt = torch.tensor([sid_tgt], dtype=torch.int64, device=dev)
                eps = None if eps is None else torch.as_tensor(eps, device=dev)
            with span("spectrogram"):
                spec = spectrogram(wav, d.filter_length, d.hop_length, d.win_length)
            o, y_mask, _ = self.gen.voice_conversion(spec, lengths, src, tgt, generator=gen,
                                                     eps=eps)
            with span("convert.download"):
                n_valid = int(y_mask[0].float().sum().item()) * d.hop_length
                return o[0, :n_valid, 0].float().cpu().numpy()

    def voice_conversion(self, source_audio: str, target_audio: str, sid_src: int,
                         sid_tgt: int, rng_seed: int = 0) -> np.ndarray:
        """Any-to-any by the posterior + flow swap, file -> file (PCM_24 at
        the target rate). The source must be audio of speaker sid_src."""
        d = self.cfg.data
        wav, sr = read_wav(source_audio)
        out = self.voice_conversion_array(resample(wav, sr, d.target_sampling_rate), sid_src,
                                          sid_tgt, rng_seed)
        write_wav(target_audio, out, d.target_sampling_rate, subtype="PCM_24")
        return out
