"""The port's data pipeline == the JAX package's, on the same files and arrays.

* `load_filelist`: the same (path, sid) list.
* `VoiceConversionDataset`: x_wav and y_wav bit-equal; x_pitch (coarse bins
  of pYIN) equal, the Viterbi decode on JAX's side taking its native C++
  path where the port's is NumPy; the same md5 cache file names, and a
  cache written by JAX's dataset is read by the port's. `preprocess` in
  worker processes writes the cache a serial pass writes.
* `bucket_lengths`, `pick_bucket`, `collate` (with the aligned random crop
  and precomputed HuBERT features) and `BucketedLoader` epochs 0 and 1:
  bit-equal arrays with the same dtypes.
* `prefetch` raises a worker's error in the consumer, and its thread ends
  when the consumer stops early; `to_device` gives the dtypes `TrainStep`
  takes.

The tiny corpus and config are tests/test_trainer.py's (four 0.45 s sines at
48 kHz, two speakers, length_buckets [0.5]); other port test files import
them from here.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.data import collate as jcollate
from vcvits_tpu.data.dataset import VoiceConversionDataset as JaxDataset
from vcvits_tpu.data.filelist import load_filelist as jax_load_filelist
from vcvits_tpu.data.loader import BucketedLoader as JaxLoader
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data import collate as tcollate
from vcvits_tpu_torch.data.dataset import VoiceConversionDataset, preprocess
from vcvits_tpu_torch.data.filelist import load_filelist
from vcvits_tpu_torch.data.loader import BATCH_DTYPES, BucketedLoader, prefetch, to_device
from vcvits_tpu_torch.utils.audio_io import write_wav

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16,
                   num_layers=1, num_heads=2, intermediate_size=32, pos_conv_kernel=8,
                   pos_conv_groups=2)


def make_corpus(tmp, seconds=0.45, n_speakers=2, per_speaker=2, name="train.txt"):
    """tests/test_trainer.py's corpus: sines at 48 kHz with a little noise,
    f0 160 + 60 * sid; returns the filelist path."""
    sr = 48000
    g = np.random.default_rng(7)
    lines = []
    for sid in range(n_speakers):
        for i in range(per_speaker):
            t = np.arange(int(sr * seconds)) / sr
            y = 0.3 * np.sin(2 * np.pi * (160 + 60 * sid) * t) + 0.02 * g.standard_normal(len(t))
            p = tmp / f"s{sid}_{i}.wav"
            write_wav(str(p), y.astype(np.float32), sr)
            lines.append(f"{p}|{sid}")
    fl = tmp / name
    fl.write_text("\n".join(lines) + "\n")
    return str(fl)


def tiny_cfg(tmp, fl, val="same", **train) -> dict:
    """tests/test_trainer.py's config dict (`train` entries override)."""
    return {
        "train": {"segment_size": 2048, "batch_size": 2, "steps_per_epoch": 10,
                  "disc_time_fold": False, "log_interval": 2, "eval_interval": 1000,
                  "checkpoint_interval": 1000, "fp16_run": False, **train},
        "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
                 "n_mel_channels": 8, "n_speakers": 4, "training_files": fl,
                 "validation_files": fl if val == "same" else val, "length_buckets": [0.5],
                 "cache_dir": str(tmp / "cache")},
        "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
                  "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1,
                  "hubert_channels": 16, "num_pitch": 64, "gin_channels": 4,
                  "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                  "resblock_dilation_sizes": [[1, 3]],
                  "multi_period_discriminator_periods": [2, 3]},
    }


class SynthDataset:
    """In-memory items with the get_item contract; lengths 0.3-1.3 s at
    16 kHz (some longer than a bucket, so collate crops)."""

    def __init__(self, n_items=14, seed=0, seconds=(0.3, 1.3), feats=False):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n_items):
            n = int(rng.uniform(*seconds) * 16000)
            item = {"x_wav": rng.standard_normal(n).astype(np.float32) * 0.1,
                    "y_wav": rng.standard_normal(n * 3).astype(np.float32) * 0.1,
                    "x_pitch": rng.integers(1, 64, n // 320), "sid": np.int64(i % 4)}
            if feats:
                item["hubert_features"] = rng.standard_normal((n // 320, 16)).astype(np.float32)
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def get_item(self, idx, pitch_shift=0):
        return self.items[idx]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    return tmp, make_corpus(tmp)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_filelist_matches_jax(tmp_path):
    fl = tmp_path / "list.txt"
    fl.write_text("a/b.wav|3\n\nc d.wav\n  e.wav|12  \n|7\n")
    assert load_filelist(str(fl)) == jax_load_filelist(str(fl)) == [
        ("a/b.wav", 3), ("c d.wav", 0), ("e.wav", 12)]


def test_dataset_items_and_cache_match_jax(corpus, tmp_path):
    tmp, fl = corpus
    cfg, jcfg = Config.from_dict(tiny_cfg(tmp, fl)), JaxConfig.from_dict(tiny_cfg(tmp, fl))
    port = VoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp_path / "port"))
    ref = JaxDataset(fl, jcfg.data, cache_dir=str(tmp_path / "jax"))
    assert port.items == ref.items
    for i in range(len(ref)):
        got, want = port.get_item(i), ref.get_item(i)
        assert set(got) == set(want) and int(got["sid"]) == int(want["sid"])
        for k in ("x_wav", "y_wav", "x_pitch"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"item {i} {k}")
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 3 * len(ref)

    # the port reads JAX's cache: plant a marker in JAX's file of item 0's source
    key = f"{ref.items[0][0]}_{jcfg.data.source_sampling_rate}"
    from vcvits_tpu.data.dataset import hash_string
    marker = np.arange(320 * 4, dtype=np.float32)
    np.save(tmp_path / "jax" / (hash_string(key) + ".npy"), marker)
    reader = VoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(reader.get_item(0)["x_wav"], marker)
    assert sorted(os.listdir(tmp_path / "jax")) == names


def test_preprocess_in_workers_writes_the_serial_cache(corpus, tmp_path):
    tmp, fl = corpus
    cfg = Config.from_dict(tiny_cfg(tmp, fl))
    for name, workers in (("serial", 1), ("workers", 2)):
        preprocess(VoiceConversionDataset(fl, cfg.data, cache_dir=str(tmp_path / name)),
                   num_workers=workers, log_every=0)
    names = sorted(os.listdir(tmp_path / "serial"))
    assert len(names) == 12 and names == sorted(os.listdir(tmp_path / "workers"))
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "serial" / n),
                                      np.load(tmp_path / "workers" / n), err_msg=n)


def test_buckets_and_collate_match_jax():
    cfg = Config.from_dict({"data": {"length_buckets": [0.5, 1.0, 1.5]}}).data
    jcfg = JaxConfig.from_dict({"data": {"length_buckets": [0.5, 1.0, 1.5]}}).data
    buckets = tcollate.bucket_lengths(cfg)
    assert buckets == jcollate.bucket_lengths(jcfg) == [10240, 17920, 25600]
    for n in (1, 10240, 10241, 25600, 10 ** 6):
        assert tcollate.pick_bucket(n, buckets) == jcollate.pick_bucket(n, buckets)
    for feats in (False, True):
        ds = SynthDataset(n_items=5, seed=3, seconds=(0.3, 2.0), feats=feats)
        for bucket in buckets:
            got = tcollate.collate(ds.items, cfg, bucket, random.Random(5))
            want = jcollate.collate(ds.items, jcfg, bucket, random.Random(5))
            _assert_batches_equal(got, want)


def test_bucketed_loader_epochs_match_jax():
    cfg = Config.from_dict({"data": {"length_buckets": [0.5, 1.0]}}).data
    jcfg = JaxConfig.from_dict({"data": {"length_buckets": [0.5, 1.0]}}).data
    ds = SynthDataset(n_items=17)
    for kw in ({}, {"shuffle": False, "drop_last": False}):
        port, ref = BucketedLoader(ds, cfg, 3, **kw), JaxLoader(ds, jcfg, 3, **kw)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            got, want = list(port.epoch_batches(epoch)), list(ref.epoch_batches(epoch))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)


def test_prefetch_reraises_worker_error():
    def items():
        yield 1
        yield 2
        raise OSError("disk gone")

    it = prefetch(items())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_prefetch_thread_ends_when_the_consumer_stops():
    import threading
    import time

    def endless():
        i = 0
        while True:
            i += 1
            yield i

    before = threading.active_count()
    it = prefetch(endless(), size=2)
    assert next(it) == 1
    assert threading.active_count() == before + 1
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_to_device_gives_train_step_dtypes():
    """The dtypes of chip_smoke.py's train batch, which TrainStep takes."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cfg = Config()
    want = chip_smoke.train_batch(cfg, 2, 0.5, 0.5, np.random.default_rng(0), "cpu")
    batch = tcollate.collate(SynthDataset(n_items=2, feats=True).items, cfg.data, 25600)
    got = to_device(batch, "cpu")
    for k, v in want.items():
        assert got[k].dtype == v.dtype == BATCH_DTYPES[k], k
    assert got["hubert_features"].dtype == torch.float32
    np.testing.assert_array_equal(got["x_pitch"].numpy(), batch["x_pitch"])
