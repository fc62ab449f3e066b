"""Precomputed-HuBERT ("preload") training data (the port's counterpart of
vcvits_tpu/data/preload.py).

`dump_hubert_features` runs the port's frozen HuBERT once over every item,
batched per length bucket, on the smoothed source (`smooth_source`, the
train step's STFT -> iSTFT), and caches the features next to the other
dataset caches under the JAX package's file names. The train step then
skips the HuBERT forward. `PreloadVoiceConversionDataset` serves them with
each item, optionally with the per-epoch random pitch-shift augmentation.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data.collate import alignment_unit, bucket_lengths, pick_bucket
from vcvits_tpu_torch.data.dataset import VoiceConversionDataset, hash_string, save_npy
from vcvits_tpu_torch.models.hubert import HubertModel
from vcvits_tpu_torch.utils.device import resolve_device

#: The augmentation policy: with p=0.3 no shift, else uniform over [-12, 12]
#: semitones (0 included, so the no-shift mass is 0.3 + 0.7/25).
SHIFT_SET = tuple(range(-12, 13))


def feature_file(dataset: VoiceConversionDataset, index: int, pitch_shift: int = 0,
                 smooth: bool = True) -> str:
    """The cache file of item `index`'s features (JAX's name for it)."""
    path, _ = dataset.items[index]
    shift_tag = f"_ps{pitch_shift}" if pitch_shift else ""
    key = f"{path}_{dataset.cfg.source_sampling_rate}{shift_tag}_hubert_smooth{int(smooth)}"
    return os.path.join(dataset.cache_dir, hash_string(key) + ".npy")


class PreloadVoiceConversionDataset(VoiceConversionDataset):
    """Items carry precomputed `hubert_features` [T50, hubert_channels]
    float32; run `dump_hubert_features` first.

    With `random_shift=True` each (epoch, index) draws a source pitch shift
    from the policy above, deterministically from the seed, so the
    loader's two get_item calls per item agree and a resumed run replays
    the same epochs. The loader advances the epoch with `set_epoch`.
    """

    def __init__(self, *args, smooth: bool = True, in_memory: bool = False,
                 random_shift: bool = False, shift_seed: int = 1234, **kwargs):
        super().__init__(*args, **kwargs)
        self.smooth = smooth
        self.random_shift = random_shift
        self.shift_seed = shift_seed
        self._epoch = 0
        self._memory: Optional[List[Dict[str, np.ndarray]]] = [] if in_memory else None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def sample_shift(self, index: int) -> int:
        """The policy's draw, deterministic in (seed, epoch, index): a str
        seed is hashed with sha512, the same in every process."""
        r = random.Random(f"{self.shift_seed}:{self._epoch}:{index}")
        if r.random() < 0.3:
            return 0
        return r.randint(-12, 12)

    def get_item(self, index: int, pitch_shift: Optional[int] = None) -> Dict[str, np.ndarray]:
        if pitch_shift is None:
            pitch_shift = self.sample_shift(index) if self.random_shift else 0
        if self._memory is not None and not pitch_shift and index < len(self._memory) \
                and self._memory[index] is not None:
            return self._memory[index]
        item = super().get_item(index, pitch_shift)
        fpath = feature_file(self, index, pitch_shift, self.smooth)
        if not os.path.exists(fpath):
            raise FileNotFoundError(
                f"precomputed HuBERT features missing for {self.items[index][0]!r} "
                f"(pitch_shift={pitch_shift}, {fpath}); run dump_hubert_features("
                f"pitch_shifts=...) / python -m vcvits_tpu_torch.cli.train --preload-dump"
                + (" --preload-shift-aug" if pitch_shift else ""))
        item["hubert_features"] = np.load(fpath)
        if self._memory is not None and not pitch_shift:
            while len(self._memory) <= index:
                self._memory.append(None)  # type: ignore[arg-type]
            self._memory[index] = item
        return item


@torch.no_grad()
def dump_hubert_features(dataset: VoiceConversionDataset, cfg: Config, hubert: HubertModel,
                         batch_size: int = 8, smooth: bool = True, log_every: int = 50,
                         pitch_shifts=(0,), device="cuda",
                         dtype: Optional[torch.dtype] = None) -> int:
    """Compute and cache HuBERT features for every item of `dataset` and
    every shift in `pitch_shifts` (`SHIFT_SET` covers the augmentation
    policy, 25 variants a file). `hubert` is the frozen HubertModel, for
    example `SynthesizerSVC.enc_p.hubert`; it runs on `device` ("cuda" by
    default; raises when no GPU is present unless device="cpu") in the
    compute dtype `dtype` (the module's own by default; bfloat16 under
    `fp16_run` when the trainer built it), as the train step runs it; the
    features are stored as float32. Files that exist are skipped. Returns
    the number of files written."""
    from vcvits_tpu_torch.models.content_encoder import HUBERT_PAD
    from vcvits_tpu_torch.train.audio_pipeline import smooth_source

    device = resolve_device(device)
    d = cfg.data
    dtype = hubert.dtype if dtype is None else dtype
    if dtype != hubert.dtype:
        weights = hubert.state_dict()
        hubert = HubertModel(hubert.cfg, dtype=dtype)
        hubert.load_state_dict(weights)
    hubert = hubert.to(device)

    def extract(wavs: np.ndarray) -> np.ndarray:
        wav = torch.from_numpy(wavs).to(device)
        if smooth:
            wav = smooth_source(wav, d.filter_length, d.hop_length, d.win_length)
        feats = hubert(F.pad(wav, (HUBERT_PAD, HUBERT_PAD)).to(dtype))
        return feats.float().cpu().numpy()

    unit = alignment_unit(d)
    buckets = bucket_lengths(d)
    # jobs are (index, pitch_shift); the phase-vocoder shift keeps the
    # length, so every variant of a file lands in the same bucket
    pools: Dict[int, List[tuple]] = {}
    pending = [(i, ps) for ps in pitch_shifts for i in range(len(dataset))
               if not os.path.exists(feature_file(dataset, i, ps, smooth))]
    written = 0

    def flush(padded_len: int):
        nonlocal written
        jobs = pools.get(padded_len, [])
        if not jobs:
            return
        wavs = np.zeros((batch_size, padded_len), np.float32)  # full batch: fixed shapes
        lens = []
        for row, (i, ps) in enumerate(jobs):
            xw = dataset.get_item(i, ps)["x_wav"]
            wavs[row, :len(xw)] = xw
            lens.append(len(xw))
        feats = extract(wavs)
        for row, (i, ps) in enumerate(jobs):
            save_npy(feature_file(dataset, i, ps, smooth),
                     feats[row, :lens[row] // d.hubert_downsample])
            written += 1
            if log_every and written % log_every == 0:
                print(f"dumped {written} feature files", flush=True)
        pools[padded_len] = []

    for i, ps in pending:
        n = len(dataset.get_item(i, ps)["x_wav"])
        # features cover the whole wav (collate may crop anywhere): a bucket
        # when one fits, else the next whole alignment unit
        b = pick_bucket(n, buckets) if n <= buckets[-1] else -(-n // unit) * unit
        pools.setdefault(b, []).append((i, ps))
        if len(pools[b]) == batch_size:
            flush(b)
    for b in list(pools):
        flush(b)
    return written
