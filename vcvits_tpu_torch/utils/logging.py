"""TensorBoard logging of scalars, mel and alignment images and audio (the
port's copy of vcvits_tpu/utils/logging.py).

`TensorBoardLogger` writes through torch.utils.tensorboard where the
`tensorboard` package is installed. Where it is not, it logs the scalars
to this module's logger and drops images and audio, as the JAX package's
logger does: a choice of where logs go, not a device fallback.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def mel_to_image(mel: np.ndarray) -> np.ndarray:
    """[T, n_mels] log-mel -> [3, n_mels, T] uint8 image, low bins at the
    bottom: viridis where matplotlib is installed, else grey."""
    mel = np.asarray(mel, dtype=np.float32).T
    lo, hi = float(mel.min()), float(mel.max())
    norm = (mel - lo) / max(hi - lo, 1e-6)
    try:
        import matplotlib.cm as cm
    except ImportError:
        img = (np.stack([norm[::-1]] * 3, -1) * 255).astype(np.uint8)
    else:
        img = (cm.viridis(norm[::-1])[..., :3] * 255).astype(np.uint8)
    return img.transpose(2, 0, 1)


def alignment_to_image(attn: np.ndarray) -> np.ndarray:
    """[T_text, T_spec] alignment -> [3, T_text, T_spec] uint8 image:
    viridis where matplotlib is installed, else grey."""
    a = np.asarray(attn, dtype=np.float32)
    lo, hi = float(a.min()), float(a.max())
    norm = (a - lo) / max(hi - lo, 1e-6)
    try:
        import matplotlib.cm as cm
    except ImportError:
        img = (np.stack([norm] * 3, -1) * 255).astype(np.uint8)
    else:
        img = (cm.viridis(norm)[..., :3] * 255).astype(np.uint8)
    return img.transpose(2, 0, 1)


class TensorBoardLogger:
    def __init__(self, logdir: str):
        self.logdir = logdir
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:  # the tensorboard package is optional
            logger.warning("TensorBoard unavailable (%s); logging scalars only", e)
            self._writer = None
        else:
            self._writer = SummaryWriter(logdir)

    def summarize(self, global_step: int, scalars: Optional[Dict[str, float]] = None,
                  images: Optional[Dict[str, np.ndarray]] = None,
                  audios: Optional[Dict[str, np.ndarray]] = None,
                  audio_sampling_rate: int = 48000) -> None:
        """Scalars, [3, H, W] uint8 images and mono audio in one call."""
        if self._writer is None:
            if scalars:
                parts = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
                logger.info("step %d %s", global_step, parts)
            return
        import torch

        for k, v in (scalars or {}).items():
            self._writer.add_scalar(k, float(v), global_step)
        for k, v in (images or {}).items():
            self._writer.add_image(k, v, global_step)
        for k, v in (audios or {}).items():
            wav = torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(1, -1))
            self._writer.add_audio(k, wav, global_step, sample_rate=audio_sampling_rate)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
