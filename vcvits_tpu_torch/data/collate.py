"""Batch assembly by length bucket (the port's copy of
vcvits_tpu/data/collate.py).

Batches are padded to a fixed bucket length from `cfg.length_buckets`, so
a run sees a small, fixed set of shapes. A clip longer than its bucket is
cropped at a random alignment-unit boundary, so source, pitch, target and
precomputed HuBERT features stay frame-locked. Pitch pads with bin 1, the
unvoiced floor; everything else pads with zeros. The arrays are NumPy with
the JAX package's dtypes, so a batch here is bit-identical to one there.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence

import numpy as np

from vcvits_tpu_torch.config import DataConfig


def alignment_unit(cfg: DataConfig) -> int:
    """Smallest source-sample count that keeps every stream frame-aligned:
    unit % hubert_downsample == 0 (pitch/HuBERT frames) and
    unit * tgt_sr % (src_sr * hop) == 0 (whole spec frames on the target).
    2560 for the 48k config (0.16 s)."""
    ds = cfg.hubert_downsample
    unit = ds
    while (unit * cfg.target_sampling_rate) % (cfg.source_sampling_rate * cfg.hop_length) != 0:
        unit += ds
    return unit


def bucket_lengths(cfg: DataConfig) -> List[int]:
    """Source-sample bucket sizes from cfg.length_buckets (seconds), each a
    whole number of alignment units."""
    unit = alignment_unit(cfg)
    out = []
    for seconds in cfg.length_buckets:
        samples = int(round(seconds * cfg.source_sampling_rate))
        out.append(max(unit, math.ceil(samples / unit) * unit))
    return sorted(set(out))


def pick_bucket(num_samples: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds `num_samples`, else the largest."""
    for b in buckets:
        if num_samples <= b:
            return b
    return buckets[-1]


def crop_aligned(xw: np.ndarray, yw: np.ndarray, pw: np.ndarray, hw, cfg: DataConfig,
                 tx: int, rng: random.Random):
    """A random alignment-unit crop of a clip longer than `tx` source
    samples: (x, y, pitch, hubert features or None), frame-locked."""
    unit = alignment_unit(cfg)
    ratio_num, ratio_den = cfg.target_sampling_rate, cfg.source_sampling_rate
    ds = cfg.hubert_downsample
    ty, tp = tx * ratio_num // ratio_den, tx // ds
    max_off = (len(xw) - tx) // unit
    off = rng.randint(0, max_off) * unit if max_off > 0 else 0
    xw = xw[off: off + tx]
    yw = yw[off * ratio_num // ratio_den:][:ty]
    pw = pw[off // ds:][:tp]
    if hw is not None:
        hw = hw[off // ds:][:tp]
    return xw, yw, pw, hw


def collate(items: Sequence[Dict[str, np.ndarray]], cfg: DataConfig, bucket: int,
            rng: random.Random | None = None) -> Dict[str, np.ndarray]:
    """items -> a padded batch with the shapes of source bucket `bucket`."""
    rng = rng or random
    if bucket % alignment_unit(cfg):
        raise ValueError(f"bucket {bucket} is not a whole number of alignment units")
    ds = cfg.hubert_downsample
    b = len(items)
    tx = bucket
    ty = bucket * cfg.target_sampling_rate // cfg.source_sampling_rate
    tp = bucket // ds

    x = np.zeros((b, tx), np.float32)
    y = np.zeros((b, ty), np.float32)
    pitch = np.ones((b, tp), np.int64)  # bin 1 == unvoiced floor
    x_lens = np.zeros((b,), np.int32)
    y_lens = np.zeros((b,), np.int32)
    sid = np.zeros((b,), np.int32)
    # the preload path's items carry precomputed HuBERT features
    has_feats = "hubert_features" in items[0]
    feats = (np.zeros((b, tp, items[0]["hubert_features"].shape[-1]), np.float32)
             if has_feats else None)

    for i, item in enumerate(items):
        xw, yw, pw = item["x_wav"], item["y_wav"], item["x_pitch"]
        hw = item.get("hubert_features")
        n = len(xw)
        if n > tx:
            xw, yw, pw, hw = crop_aligned(xw, yw, pw, hw, cfg, tx, rng)
            n = tx
        x[i, :n] = xw
        ny = min(len(yw), ty)
        y[i, :ny] = yw[:ny]
        np_ = min(len(pw), tp)
        pitch[i, :np_] = pw[:np_]
        if feats is not None and hw is not None:
            nh = min(len(hw), tp)
            feats[i, :nh] = hw[:nh]
        x_lens[i] = n
        y_lens[i] = ny
        sid[i] = int(item["sid"])

    out = {"x_wav": x, "x_wav_lengths": x_lens, "x_pitch": pitch, "y_wav": y,
           "y_wav_lengths": y_lens, "sid": sid}
    if feats is not None:
        out["hubert_features"] = feats
    return out
