"""The training loop: data -> GAN train step -> logging, checkpoints,
validation (the port's counterpart of vcvits_tpu/train/trainer.py).

`Trainer.fit` picks the loader (the streaming `BucketedLoader` with a
background prefetch and a pinned copy to the card, the device-resident
`DeviceBatcher` when the corpus fits, or the preload dataset of
precomputed HuBERT features), resumes from the latest checkpoint with the
shape-tolerant restore, and runs `TrainStep` until `max_steps`, the
`max_seconds` deadline, `request_stop()` or a SIGTERM/SIGINT, each of
which ends at a step boundary with a checkpoint. `Trainer.validate` runs
one validation batch through the generator's inference path in the
compute dtype (kernels K1 and K2, bf16 weights and activations in a bf16
run), takes the mel images of the generated and ground-truth clips and
the objective metrics through K4, and logs them with the audio.

Behaviours mirrored from the JAX trainer as they are: every `fit` reseeds
the step's generators from `cfg.train.seed` (no random state is
checkpointed), and after a resume the epoch loop starts again at epoch 0.

Under torch.distributed (one process per rank, parallel/mesh.py:
distributed_init) the trainer runs on `training_mesh(batch_size,
model_parallel)`: each data rank's loader yields its rows of every global
batch (the same order from the same seed everywhere), the step keeps the
global batch's losses, and the model group shares the sharded layers.
Rank 0 alone writes config.json, TensorBoard and the checkpoints; every
rank restores them (whole tensors) into its own layout. A stop request,
a signal or the `max_seconds` deadline (rank 0's clock) is agreed by all
ranks at the step boundary, so no rank is left in a collective alone.
Validation runs on every rank (the model group's collectives need them
all) and rank 0 logs it.

Program spans (utils/profiling.py) mark the blocks its history times:
"vcvits.fit.loader_wait" (each wait for the next batch),
"vcvits.fit.validate" and "vcvits.fit.checkpoint"; the step's own are
train/step.py's.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data.dataset import VoiceConversionDataset
from vcvits_tpu_torch.data.device_cache import DeviceBatcher, estimate_corpus_bytes
from vcvits_tpu_torch.data.loader import BucketedLoader, prefetch, to_device
from vcvits_tpu_torch.data.preload import PreloadVoiceConversionDataset
from vcvits_tpu_torch.eval import evaluate_pair
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.ops.stft_mel import mel_spectrogram
from vcvits_tpu_torch.parallel.mesh import training_mesh
from vcvits_tpu_torch.train.checkpoint import CheckpointManager
from vcvits_tpu_torch.train.step import TrainStep
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.logging import TensorBoardLogger, mel_to_image
from vcvits_tpu_torch.utils.memory import trim_host_memory
from vcvits_tpu_torch.utils.profiling import span

class NullLogger:
    """TensorBoardLogger's interface, writing nothing (the ranks but 0)."""

    def summarize(self, *args, **kwargs) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _spanned(batches):
    """The batches, each wait for the next one in a "fit.loader_wait" span."""
    it = iter(batches)
    while True:
        with span("fit.loader_wait"):
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


# steps between malloc_trim(0) calls in fit(): often enough to bound the
# host arena's growth, rarely enough that the syscall's cost is invisible
_TRIM_INTERVAL = 200

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, cfg: Config, workdir: str = "logs", device="cuda",
                 hubert_cfg: Optional[HubertConfig] = None, preload: bool = False,
                 preload_shift_aug: bool = False, model_parallel: int = 1,
                 dtype: torch.dtype = torch.float32):
        """A trainer on `device` ("cuda" by default; raises when no GPU is
        present unless device="cpu") in the compute dtype `dtype` (float32
        or bfloat16; parameters and optimizer stay float32), which
        `validate`'s inference path runs in too. Steps are counted in
        mini-steps (`accumulate_grad_batches` of them make an update), as
        JAX's `state.step`: `max_steps` and every interval count them.
        Writes `config.json` into `workdir`, beside `tb/` (TensorBoard) and
        `checkpoints/`. `preload` trains from precomputed HuBERT features
        (data/preload.py); `preload_shift_aug` adds the per-epoch random
        source pitch shift. Under torch.distributed, `model_parallel`
        ranks share a model (it must divide the world; see the module
        docstring); on one process it must be 1."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.workdir = workdir
        self.preload = preload
        self.preload_shift_aug = preload_shift_aug
        self.mesh = training_mesh(cfg.train.batch_size, model_parallel)
        if self.mesh.is_main:
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=1)
        self.tb = TensorBoardLogger(os.path.join(workdir, "tb")) if self.mesh.is_main \
            else NullLogger()
        self.ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
        self.dtype = dtype
        # a rank the mesh leaves out builds nothing, and its fit returns None
        self.train_step = TrainStep(cfg, device=self.device, hubert_cfg=hubert_cfg,
                                    seed=cfg.train.seed, dtype=dtype,
                                    mesh=self.mesh) if self.mesh.active else None
        # the schedule's epoch length: the config's, else the first fit's loader's
        self._steps_per_epoch: Optional[int] = cfg.train.steps_per_epoch
        # set by request_stop() or a signal handler, read at each step boundary
        self._stop_reason: Optional[str] = None
        # what the last fit() used and did: the loader kind, the restore
        # seconds, and per step its seconds waiting on the loader, in the
        # step (with the metric read at log steps), validating, checkpointing
        self.loader_kind: Optional[str] = None
        self.restore_s: Optional[float] = None
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ setup
    def _maybe_device_cache(self, train_ds, train_loader):
        """The device-resident batcher in place of the streaming loader when
        cfg.train.device_data_cache is "on", or "auto" and the padded corpus
        fits device_cache_max_bytes. The preload path keeps streaming."""
        t = self.cfg.train
        if t.device_data_cache == "off":
            return train_loader
        if self.preload:
            if t.device_data_cache == "on":
                logger.warning("device_data_cache ignored: the preload path feeds precomputed "
                               "HuBERT features (and may draw a pitch shift per epoch); "
                               "streaming loader kept")
            return train_loader
        if t.device_data_cache == "auto":
            est = estimate_corpus_bytes(train_ds, self.cfg.data)
            if est > t.device_cache_max_bytes:
                logger.info("device_data_cache=auto: corpus ~%.0f MB exceeds the %.0f MB gate; "
                            "streaming loader kept", est / 1e6, t.device_cache_max_bytes / 1e6)
                return train_loader
        batcher = DeviceBatcher(train_ds, self.cfg.data, t.batch_size, device=self.device,
                                shard=self._shard())
        logger.info("device_data_cache: %d items resident on %s (%d batches/epoch)",
                    len(train_ds), self.device, len(batcher))
        return batcher

    def _shard(self):
        """This rank's place on the data axis, for the loaders."""
        return self.mesh.data_rank, self.mesh.data

    def save(self, step_no: int) -> None:
        """Checkpoint the step's state: every rank gathers (the sharded
        tensors' collectives), rank 0 writes."""
        state = self.train_step.state_dict()
        if self.mesh.is_main:
            self.ckpt.save(step_no, state)

    def resume_or_init(self) -> int:
        """Restore the latest checkpoint, if there is one, into the step
        (shape-tolerant); returns the step number to continue from."""
        step = self.ckpt.latest_step()
        if step is not None:
            t0 = time.perf_counter()
            state, changed = self.ckpt.restore_tolerant(self.train_step.state_dict(), step)
            self.train_step.load_state_dict(state)
            self.restore_s = time.perf_counter() - t0
            logger.info("resumed from step %d (tolerant=%s)", step, changed)
        return self.train_step.step

    # ---------------------------------------------------------- preemption
    def request_stop(self, reason: str = "request_stop") -> None:
        """Ask the running fit() to checkpoint and return at the next step
        boundary (thread-safe: it sets a flag the loop reads)."""
        self._stop_reason = reason

    def _install_preemption_handlers(self):
        """SIGTERM/SIGINT -> checkpoint and return at the next step boundary;
        a second signal falls through to the previous handler. Returns the
        (signal, previous handler) pairs to restore; none off the main
        thread, where signal.signal would raise."""
        if threading.current_thread() is not threading.main_thread():
            return []
        prev = {}

        def _handler(signum, frame):  # noqa: ARG001
            name = signal.Signals(signum).name
            self._stop_reason = name
            logger.warning("received %s: checkpointing and exiting at the next step boundary "
                           "(send again to kill immediately)", name)
            # a handler installed by non-Python code reads as None: SIG_DFL
            old = prev.get(signum)
            signal.signal(signum, signal.SIG_DFL if old is None else old)

        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, _handler)
        return list(prev.items())

    # ------------------------------------------------------------------- fit
    def fit(self, train_files: Optional[str] = None, val_files: Optional[str] = None,
            max_steps: Optional[int] = None, train_loader=None, val_loader=None,
            max_seconds: Optional[float] = None) -> Optional[int]:
        """Train until max_steps, max_seconds (0 stops at the first step
        boundary), request_stop() or a signal, or cfg.train.max_epochs.
        Returns the final step number (None when no batch came, or on a
        rank the mesh leaves out)."""
        cfg = self.cfg
        if not self.mesh.active:
            logger.warning("this rank is outside the %dx%d training mesh: not training",
                           self.mesh.data, self.mesh.model)
            return None
        if train_loader is None:
            if self.preload:
                train_ds = PreloadVoiceConversionDataset(
                    train_files or cfg.data.training_files, cfg.data,
                    random_shift=self.preload_shift_aug, shift_seed=cfg.train.seed)
            else:
                train_ds = VoiceConversionDataset(train_files or cfg.data.training_files,
                                                  cfg.data)
            train_loader = self._maybe_device_cache(
                train_ds, BucketedLoader(train_ds, cfg.data, cfg.train.batch_size,
                                         shard=self._shard()))
        # batches of the device batcher are on the device already
        device_cached = isinstance(train_loader, DeviceBatcher)
        self.loader_kind = ("device_cache" if device_cached
                            else "preload" if self.preload else "streaming")
        if val_loader is None and (val_files or cfg.data.validation_files):
            try:
                val_ds = VoiceConversionDataset(val_files or cfg.data.validation_files, cfg.data)
            except FileNotFoundError:
                val_ds = None
            if val_ds is not None:
                val_loader = BucketedLoader(val_ds, cfg.data,
                                            min(cfg.train.batch_size, max(len(val_ds), 1)),
                                            shuffle=False, drop_last=False)

        self._steps_per_epoch = self._steps_per_epoch or max(len(train_loader), 1)
        step = self.train_step
        step.set_steps_per_epoch(self._steps_per_epoch)
        step.generator.manual_seed(cfg.train.seed)
        step.dropout_generator.manual_seed(cfg.train.seed + 1)
        self.history = []
        self.restore_s = None
        step_no: Optional[int] = None
        t_log = time.perf_counter()
        deadline = time.monotonic() + max_seconds if max_seconds is not None else None
        # _stop_reason is not cleared here: request_stop() may come before
        # fit(). The finally block consumes it.
        handlers = self._install_preemption_handlers()
        try:
            for epoch in range(cfg.train.max_epochs):
                batches = (train_loader.epoch_batches(epoch) if device_cached
                           else prefetch(train_loader.epoch_batches(epoch)))
                t_wait = time.perf_counter()
                for batch in _spanned(batches):
                    wait_s = time.perf_counter() - t_wait
                    if step_no is None:
                        step_no = self.resume_or_init()
                    if max_steps is not None and step_no >= max_steps:
                        return self._finish(step_no)
                    late = deadline is not None and self.mesh.is_main \
                        and time.monotonic() >= deadline
                    if self.mesh.agree(self._stop_reason is not None or late):
                        reason = self._stop_reason or (f"time limit {max_seconds:.0f}s" if late
                                                       else "a stop on another rank")
                        logger.warning("graceful stop at step %d (%s): saving final checkpoint",
                                       step_no, reason)
                        return self._finish(step_no)
                    t0 = time.perf_counter()
                    if not device_cached:
                        batch = to_device(batch, self.device)
                    metrics = step(batch)
                    step_no += 1
                    if step_no % cfg.train.log_interval == 0 and self.mesh.is_main:
                        scalars = {k: float(v) for k, v in metrics.items()}
                        sps = cfg.train.log_interval / max(time.perf_counter() - t_log, 1e-9)
                        t_log = time.perf_counter()
                        self.tb.summarize(step_no, scalars={**scalars, "steps_per_sec": sps})
                        logger.info("step %d loss_g=%.3f loss_d=%.3f mel=%.3f (%.2f steps/s)",
                                    step_no, scalars["loss/g/total"], scalars["loss/d/total"],
                                    scalars["loss/g/mel"], sps)
                    record = {"step": step_no, "wait_s": wait_s,
                              "run_s": time.perf_counter() - t0}
                    if val_loader is not None and step_no % cfg.train.eval_interval == 0:
                        t1 = time.perf_counter()
                        with span("fit.validate", step=step_no):
                            self.validate(val_loader, step_no)
                        record["validate_s"] = time.perf_counter() - t1
                    if step_no % cfg.train.checkpoint_interval == 0:
                        t1 = time.perf_counter()
                        with span("fit.checkpoint", step=step_no):
                            self.save(step_no)
                        record["checkpoint_s"] = time.perf_counter() - t1
                    if step_no % _TRIM_INTERVAL == 0:
                        trim_host_memory(collect=False)
                    self.history.append(record)
                    t_wait = time.perf_counter()
            return self._finish(step_no) if step_no is not None else None
        finally:
            # a later fit() in this process starts without a stale stop flag,
            # also when this one ends in an exception
            self._stop_reason = None
            for sig, old in handlers:
                signal.signal(sig, signal.SIG_DFL if old is None else old)

    def _finish(self, step_no: int) -> int:
        main = self.mesh.is_main
        if main:
            self.ckpt.wait()
        if self.mesh.agree(main and self.ckpt.latest_step() != step_no):
            self.save(step_no)
        if main:
            self.ckpt.wait()
        self.tb.flush()
        self.tb.close()
        logger.info("training finished at step %d", step_no)
        return step_no

    # ------------------------------------------------------------- validation
    def validate(self, val_loader, step_no: int) -> Optional[Dict[str, float]]:
        """One validation batch: infer its first clip, log the mel images
        of the generated and ground-truth clips and their audio, and the
        objective metrics (MCD, F0 RMSE, voicing F1) against the ground
        truth. Returns the scalar metrics (rank 0; None on the others,
        which take part in the sharded layers' collectives only)."""
        d = self.cfg.data
        try:
            batch = next(iter(val_loader.epoch_batches(0)))
        except StopIteration:
            return None
        on_dev = to_device(batch, self.device)
        gen = self.train_step.gen
        gen.eval()
        try:
            o, y_mask, _ = gen.infer(on_dev["x_wav"], on_dev["x_wav_lengths"], on_dev["x_pitch"],
                                     on_dev["sid"],
                                     generator=torch.Generator(device=self.device).manual_seed(0))
        finally:
            gen.train()
        if not self.mesh.is_main:
            return None
        # count in float32: a bf16 sum of more than 256 ones rounds
        n_valid = int(y_mask[0].float().sum().item()) * d.hop_length
        o = o[0, :n_valid, 0].float()
        y = batch["y_wav"][0][: int(batch["y_wav_lengths"][0])]

        def mel_of(wav: torch.Tensor) -> np.ndarray:
            t = (wav.shape[0] // d.hop_length) * d.hop_length
            if t == 0:
                return np.zeros((1, d.n_mel_channels), np.float32)
            return mel_spectrogram(wav[None, :t], d.filter_length, d.n_mel_channels,
                                   d.target_sampling_rate, d.hop_length, d.win_length,
                                   d.mel_fmin, d.mel_fmax)[0].cpu().numpy()

        o_np = o.cpu().numpy()
        scalars = {}
        # the same utterance, so MCD without DTW; F0 tracked at the 16 kHz
        # front-end rate
        try:
            m = evaluate_pair(y, o_np, d.target_sampling_rate, pitch_sr=d.source_sampling_rate,
                              use_dtw=False, device=self.device)
            scalars["val/mcd_db"] = m["mcd_db"]
            scalars["val/voicing_f1"] = m["voicing_f1"]
            if np.isfinite(m["f0_rmse_cents"]):
                scalars["val/f0_rmse_cents"] = m["f0_rmse_cents"]
        except Exception:  # noqa: BLE001 - a metric's failure must not end training
            logger.exception("validation metrics failed")
        self.tb.summarize(
            step_no, scalars=scalars,
            images={"gen/mel": mel_to_image(mel_of(o)),
                    "gt/mel": mel_to_image(mel_of(torch.as_tensor(y, device=self.device)))},
            audios={"gen/audio": o_np, "gt/audio": y},
            audio_sampling_rate=d.target_sampling_rate)
        self.tb.flush()
        return scalars
