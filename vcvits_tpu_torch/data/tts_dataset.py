"""TTS dataset: (text, audio, speaker) triples with cached features (the
port's copy of vcvits_tpu/data/tts_dataset.py).

Filelist lines are "path|sid|text" ("path|text": speaker 0). Per item: the
wav resampled to the target rate, and a frame-level F0 target (pYIN at the
spectrogram hop, for the pitch predictor; left out with `pitch=False`, for
a model without one), each cached as `<md5 of its
key>.npy` under the JAX package's keys, so either package reads the
other's cache; the text through the port's text front end. The resampler
and pYIN's Viterbi run in the port's C++ host library (its arrays equal
the NumPy versions').
`collate_tts` pads a batch to the static (text bucket, audio bucket)
shapes, cropping a longer clip at a random hop-aligned offset; its batch
has "pitch" where the items have it.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vcvits_tpu_torch.config import DataConfig
from vcvits_tpu_torch.data.dataset import hash_string, save_npy
from vcvits_tpu_torch.dsp.pitch import estimate_pitch
from vcvits_tpu_torch.dsp.resample import resample
from vcvits_tpu_torch.text import intersperse, text_to_sequence
from vcvits_tpu_torch.utils.audio_io import read_wav


def load_tts_filelist(path: str) -> List[Tuple[str, int, str]]:
    items = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 3:
                items.append((parts[0], int(parts[1]), parts[2]))
            elif len(parts) == 2:
                items.append((parts[0], 0, parts[1]))
    return items


class TTSDataset:
    def __init__(self, filelist_path: str, cfg: DataConfig,
                 cleaners: Sequence[str] = ("english_cleaners",), cache_dir: Optional[str] = None,
                 shuffle_seed: Optional[int] = 1234, add_blank: bool = False,
                 pitch: bool = True):
        self.items = load_tts_filelist(filelist_path)
        self.cfg = cfg
        self.cleaners = tuple(cleaners)
        self.add_blank = add_blank  # blank id 0 between symbols (VITS's data.add_blank)
        self.pitch = pitch
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

    def get_item(self, index: int) -> Dict[str, np.ndarray]:
        path, sid, text = self.items[index]
        cfg = self.cfg
        sr = cfg.target_sampling_rate

        def load() -> np.ndarray:
            wav, in_sr = read_wav(path)
            return resample(wav, in_sr, sr)

        y_wav = self._cached(f"{path}_{sr}", load)
        ids = text_to_sequence(text, self.cleaners)
        if self.add_blank:
            ids = intersperse(ids, 0)
        item = {"sid": np.int64(sid), "text": np.asarray(ids, np.int64), "y_wav": y_wav}
        if self.pitch:
            item["pitch"] = self._cached(
                f"{path}_ttsf0_{cfg.filter_length}_{cfg.win_length}_{sr}_{cfg.hop_length}",
                lambda: estimate_pitch(y_wav, sr=sr, n_fft=cfg.filter_length,
                                       win_length=cfg.win_length, hop_length=cfg.hop_length))
        return item

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_item(index)


def collate_tts(items: Sequence[Dict[str, np.ndarray]], cfg: DataConfig, text_bucket: int,
                audio_bucket: int, rng: Optional[random.Random] = None,
                rows: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """Pad to the static (text_bucket ids, audio_bucket samples) shapes; a
    longer clip is cropped at a hop-aligned offset drawn from `rng`.
    `rows` = (lo, hi) fills only those rows (a data-parallel rank's); every
    item's crop is still drawn in order."""
    rng = rng or random
    hop = cfg.hop_length
    audio_bucket = (audio_bucket // hop) * hop
    lo, hi = rows or (0, len(items))
    b = hi - lo
    t_frames = audio_bucket // hop

    text = np.zeros((b, text_bucket), np.int64)
    text_lens = np.zeros((b,), np.int32)
    y = np.zeros((b, audio_bucket), np.float32)
    y_lens = np.zeros((b,), np.int32)
    with_pitch = "pitch" in items[0]
    pitch = np.zeros((b, t_frames), np.float32)
    sid = np.zeros((b,), np.int32)
    for j, item in enumerate(items):
        yw, pw = item["y_wav"], item.get("pitch")
        n = len(yw)
        if n > audio_bucket:
            max_off = (n - audio_bucket) // hop
            off = rng.randint(0, max_off) * hop if max_off > 0 else 0
            yw = yw[off:off + audio_bucket]
            if with_pitch:
                pw = pw[off // hop:][:t_frames]
            n = audio_bucket
        if not lo <= j < hi:
            continue
        i = j - lo
        seq = item["text"][:text_bucket]
        text[i, :len(seq)] = seq
        text_lens[i] = len(seq)
        n = (n // hop) * hop
        y[i, :n] = yw[:n]
        y_lens[i] = n
        if with_pitch:
            n_p = min(len(pw), t_frames)
            pitch[i, :n_p] = pw[:n_p]
        sid[i] = int(item["sid"])
    batch = {"text": text, "text_lengths": text_lens, "y_wav": y, "y_wav_lengths": y_lens}
    if with_pitch:
        batch["pitch"] = pitch
    batch["sid"] = sid
    return batch
