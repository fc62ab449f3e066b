"""A corpus resident on the device: upload once, batch by index (the
port's counterpart of vcvits_tpu/data/device_cache.py).

The corpus is padded per length bucket and uploaded to the device once, as
one stacked tensor per stream and bucket. A batch is then an index gather
on the device, so each step copies a few bytes of indices instead of the
audio. Batches are bit-identical to `BucketedLoader` + `collate` copied to
the device (`data/loader.to_device`): the same per-epoch
`random.Random(seed + epoch)` shuffle, the same bucket pooling, the same
padding and dtypes. The one difference is the random aligned crop of a
clip longer than the largest bucket, taken once when the store is built
(epoch-stable) instead of each epoch.

Sized for corpora that fit in device memory beside the model: the
Trainer's gate (`device_data_cache`, `device_cache_max_bytes`) compares
`estimate_corpus_bytes` with the limit.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, Iterator, List

import numpy as np
import torch

from vcvits_tpu_torch.config import DataConfig
from vcvits_tpu_torch.data.collate import bucket_lengths, crop_aligned, pick_bucket
from vcvits_tpu_torch.data.loader import BATCH_DTYPES
from vcvits_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def estimate_corpus_bytes(dataset, cfg: DataConfig) -> int:
    """Padded-to-bucket footprint of the dataset as JAX's store counts it
    (x f32 + y f32 + pitch i32 per item)."""
    buckets = bucket_lengths(cfg)
    ratio = cfg.target_sampling_rate / cfg.source_sampling_rate
    total = 0
    for i in range(len(dataset)):
        b = pick_bucket(len(dataset.get_item(i)["x_wav"]), buckets)
        total += b * 4 + int(b * ratio) * 4 + (b // cfg.hubert_downsample) * 4
    return total


class DeviceBatcher:
    """Batches gathered on `device` ("cuda" by default; raises when no GPU
    is present unless device="cpu") from a one-time upload. The same
    `epoch_batches(epoch)` and `len()` as `BucketedLoader`."""

    def __init__(self, dataset, cfg: DataConfig, batch_size: int, seed: int = 1234,
                 shuffle: bool = True, drop_last: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.buckets = bucket_lengths(cfg)
        ds = cfg.hubert_downsample
        self._bucket_of: List[int] = []
        self._row_of: List[int] = []  # row within its bucket's store
        rows: Dict[int, List[tuple]] = {b: [] for b in self.buckets}
        crop_rng = random.Random(seed)
        n_cropped = 0
        for idx in range(len(dataset)):
            item = dataset.get_item(idx)
            xw, yw, pw = item["x_wav"], item["y_wav"], item["x_pitch"]
            b = pick_bucket(len(xw), self.buckets)
            tx, ty, tp = b, b * cfg.target_sampling_rate // cfg.source_sampling_rate, b // ds
            if len(xw) > tx:  # build-time aligned crop (epoch-stable)
                xw, yw, pw, _ = crop_aligned(xw, yw, pw, None, cfg, tx, crop_rng)
                n_cropped += 1
            x = np.zeros((tx,), np.float32)
            y = np.zeros((ty,), np.float32)
            p = np.ones((tp,), np.int64)
            x[:len(xw)] = xw
            ny = min(len(yw), ty)
            y[:ny] = yw[:ny]
            npi = min(len(pw), tp)
            p[:npi] = pw[:npi]
            self._bucket_of.append(b)
            self._row_of.append(len(rows[b]))
            rows[b].append((x, y, p, int(item["sid"]), min(len(xw), tx), ny))
        if n_cropped:
            logger.info("device cache: %d clips longer than the largest bucket were cropped "
                        "once at build time (BucketedLoader crops them each epoch)", n_cropped)

        def put(key, arr):
            return torch.from_numpy(arr).to(BATCH_DTYPES[key]).to(self.device)

        self._store: Dict[int, Dict[str, torch.Tensor]] = {}
        for b, items in rows.items():
            if items:
                self._store[b] = {
                    "x_wav": put("x_wav", np.stack([r[0] for r in items])),
                    "x_wav_lengths": put("x_wav_lengths", np.array([r[4] for r in items])),
                    "x_pitch": put("x_pitch", np.stack([r[2] for r in items])),
                    "y_wav": put("y_wav", np.stack([r[1] for r in items])),
                    "y_wav_lengths": put("y_wav_lengths", np.array([r[5] for r in items])),
                    "sid": put("sid", np.array([r[3] for r in items])),
                }
        self._n_items = len(dataset)

    def __len__(self) -> int:
        """As BucketedLoader's: the Trainer derives the schedule's
        steps_per_epoch from it, so the two loaders must agree."""
        return self._n_items // self.batch_size

    def _gather(self, b: int, rows: List[int]) -> Dict[str, torch.Tensor]:
        idx = torch.tensor(rows, dtype=torch.int64).to(self.device, non_blocking=True)
        return {k: v.index_select(0, idx) for k, v in self._store[b].items()}

    def epoch_batches(self, epoch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """BucketedLoader.epoch_batches's order: the shuffled item order,
        per-bucket pools, a batch whenever a pool fills."""
        rng = random.Random(self.seed + epoch)
        order = list(range(self._n_items))
        if self.shuffle:
            rng.shuffle(order)
        pools: Dict[int, List[int]] = {b: [] for b in self.buckets}
        for idx in order:
            b = self._bucket_of[idx]
            pools[b].append(self._row_of[idx])
            if len(pools[b]) == self.batch_size:
                yield self._gather(b, pools[b])
                pools[b] = []
        if not self.drop_last:
            for b, pool in pools.items():
                if pool:
                    n_real = len(pool)
                    while len(pool) < self.batch_size:  # BucketedLoader's repeat rule
                        pool.append(pool[len(pool) % n_real])
                    yield self._gather(b, pool)
