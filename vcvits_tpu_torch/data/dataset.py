"""Voice-conversion dataset with an on-disk feature cache (the port's copy
of vcvits_tpu/data/dataset.py).

Per item: read the wav, resample it to the 16 kHz source and the 48 kHz
target rates, pYIN the source and quantise the f0 to coarse bins. Each
result is cached as `<md5 of its key>.npy` in the cache directory, under
the same keys as the JAX package, so a cache written by either package is
read by the other. Host side only: the resampler and pYIN's Viterbi run
in the port's C++ library, or with `plain_dsp=True` in their NumPy
versions.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vcvits_tpu_torch.config import DataConfig
from vcvits_tpu_torch.data.filelist import load_filelist
from vcvits_tpu_torch.dsp import host_dsp
from vcvits_tpu_torch.dsp.pitch import coarse_f0, estimate_pitch
from vcvits_tpu_torch.dsp.pitch_shift import pitch_shift as shift_semitones
from vcvits_tpu_torch.dsp.resample import resample
from vcvits_tpu_torch.utils.audio_io import read_wav


def hash_string(s: str) -> str:
    return hashlib.md5(s.encode("utf-8")).hexdigest()


def save_npy(path: str, value: np.ndarray) -> None:
    """np.save through a temporary name and a rename, so a reader never
    sees a partial file."""
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:  # a file handle: np.save appends no .npy
        np.save(f, value)
    os.replace(tmp, path)


class VoiceConversionDataset:
    """Indexable host-side dataset; items are dicts of NumPy arrays."""

    def __init__(self, filelist_path: str, cfg: DataConfig, cache_dir: Optional[str] = None,
                 shuffle_seed: Optional[int] = 1234, plain_dsp: bool = False):
        self.items: List[Tuple[str, int]] = load_filelist(filelist_path)
        self.cfg = cfg
        self.plain_dsp = plain_dsp
        self.cache_dir = cache_dir or cfg.cache_dir
        os.makedirs(self.cache_dir, exist_ok=True)
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def _cached(self, key: str, compute) -> np.ndarray:
        path = os.path.join(self.cache_dir, hash_string(key) + ".npy")
        if os.path.exists(path):
            return np.load(path)
        value = compute()
        save_npy(path, value)
        return value

    def get_item(self, index: int, pitch_shift: int = 0) -> Dict[str, np.ndarray]:
        """`pitch_shift` (semitones) shifts the SOURCE side only (x_wav and
        its pitch track); the 48 kHz target stays unshifted. Shifted
        variants cache under their own keys."""
        path, sid = self.items[index]
        cfg = self.cfg
        src_sr, tgt_sr = cfg.source_sampling_rate, cfg.target_sampling_rate
        audio: Dict[str, object] = {}

        def load() -> np.ndarray:
            if "wav" not in audio:
                audio["wav"], audio["sr"] = read_wav(path)
            return audio["wav"]

        shift_tag = f"_ps{pitch_shift}" if pitch_shift else ""

        plain = self.plain_dsp

        def source() -> np.ndarray:
            wav = resample(load(), int(audio["sr"]), src_sr, plain=plain)
            return shift_semitones(wav, src_sr, pitch_shift, plain=plain) if pitch_shift else wav

        x_wav = self._cached(f"{path}_{src_sr}{shift_tag}", source)
        y_wav = self._cached(f"{path}_{tgt_sr}",
                             lambda: resample(load(), int(audio["sr"]), tgt_sr, plain=plain))
        pitch_key = f"{path}_{cfg.filter_length}_{cfg.win_length}_{cfg.num_pitch}_{src_sr}{shift_tag}"
        x_pitch = self._cached(pitch_key, lambda: coarse_f0(
            estimate_pitch(x_wav, sr=src_sr, n_fft=cfg.filter_length,
                           win_length=cfg.win_length, hop_length=320, plain=plain),
            f0_bin=cfg.num_pitch))
        return {"sid": np.int64(sid), "x_wav": x_wav, "x_pitch": x_pitch, "y_wav": y_wav}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_item(index)


def _warm(dataset: VoiceConversionDataset, indices: Sequence[int]) -> int:
    for i in indices:
        dataset.get_item(i)
    return len(indices)


def preprocess(dataset: VoiceConversionDataset, num_workers: int = 4,
               log_every: int = 200) -> None:
    """Warm the cache for every item, in `num_workers` processes (spawned:
    the resampler and pYIN hold the interpreter lock for much of their
    time, so threads would not run them in parallel)."""
    n = len(dataset)
    if not dataset.plain_dsp:
        host_dsp.library()  # build the C++ library once, before the workers load it
    if num_workers <= 1:
        for i in range(n):
            dataset.get_item(i)
            if log_every and i % log_every == 0:
                print(f"preprocess {i}/{n}", flush=True)
        return
    # chunks of at most log_every items, dealt round-robin over the workers
    step = max(1, min(log_every or n, -(-n // num_workers)))
    chunks = [range(i, min(i + step, n)) for i in range(0, n, step)]
    done = 0
    with ProcessPoolExecutor(num_workers,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        for count in ex.map(_warm, [dataset] * len(chunks), chunks):
            done += count
            if log_every:
                print(f"preprocess {done}/{n}", flush=True)
