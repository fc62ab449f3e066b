"""Host-side batch pipeline (the port's copy of vcvits_tpu/data/loader.py):
bucketed batching, background prefetch, and the copy to the step's device.

`BucketedLoader` groups items by length bucket and collates each full
bucket pool into a padded NumPy batch, in the JAX package's order, so its
batches are bit-identical to JAX's. `prefetch` assembles them on a
background thread. `to_device` is the one-device counterpart of JAX's
`shard_batch`: NumPy -> pinned host tensors -> a non-blocking copy to the
device, in the dtypes `TrainStep` takes.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List, Mapping

import numpy as np
import torch

from vcvits_tpu_torch.config import DataConfig
from vcvits_tpu_torch.data.collate import bucket_lengths, collate, pick_bucket

# the dtypes TrainStep takes, by batch key
BATCH_DTYPES = {"x_wav": torch.float32, "x_wav_lengths": torch.int32,
                "x_pitch": torch.int64, "y_wav": torch.float32,
                "y_wav_lengths": torch.int32, "sid": torch.int64,
                "hubert_features": torch.float32}


class BucketedLoader:
    """Yields padded batches; each batch's items share one length bucket."""

    def __init__(self, dataset, cfg: DataConfig, batch_size: int, seed: int = 1234,
                 drop_last: bool = True, shuffle: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.buckets = bucket_lengths(cfg)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch_batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch)
        if hasattr(self.dataset, "set_epoch"):
            # per-epoch augmentation (the preload path's random pitch shift)
            self.dataset.set_epoch(epoch)
        order = list(range(len(self.dataset)))
        if self.shuffle:
            rng.shuffle(order)

        pools: Dict[int, List[int]] = {b: [] for b in self.buckets}
        for idx in order:
            item = self.dataset.get_item(idx)
            b = pick_bucket(len(item["x_wav"]), self.buckets)
            pools[b].append(idx)
            if len(pools[b]) == self.batch_size:
                yield collate([self.dataset.get_item(i) for i in pools[b]], self.cfg, b, rng)
                pools[b] = []
        if not self.drop_last:
            for b, pool in pools.items():
                if pool:
                    items = [self.dataset.get_item(i) for i in pool]
                    # fill the batch by repeating its items (fixed shapes)
                    while len(items) < self.batch_size:
                        items.append(items[len(items) % len(pool)])
                    yield collate(items, self.cfg, b, rng)


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run `iterator` on a background thread, keeping `size` items ready.
    An exception in the iterator is raised again in the consumer; when the
    consumer stops early (the generator is closed), the thread stops after
    the item it is making."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A NumPy batch -> tensors on `device` in the train step's dtypes. For
    a CUDA device each array goes through pinned host memory and a
    non-blocking copy on the current stream."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(BATCH_DTYPES.get(k, t.dtype))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out

