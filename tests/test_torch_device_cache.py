"""The device-resident batcher == BucketedLoader + collate + to_device.

`DeviceBatcher(device="cpu")` against the port's streaming loader copied
with `to_device`: every batch of epochs 0, 1 and 5 bit-equal in values and
dtypes, with batches that differ across epochs; an over-long clip is
cropped once, at build time. `estimate_corpus_bytes` equals JAX's on the
same dataset, and the Trainer's auto gate takes the device cache below
`device_cache_max_bytes` and the streaming loader above it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_data import TINY_HUBERT, SynthDataset, make_corpus, tiny_cfg
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.data.device_cache import estimate_corpus_bytes as jax_estimate
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data.collate import bucket_lengths
from vcvits_tpu_torch.data.device_cache import DeviceBatcher, estimate_corpus_bytes
from vcvits_tpu_torch.data.loader import BucketedLoader, to_device

torch.set_num_threads(1)

BUCKETS = {"data": {"length_buckets": [0.5, 1.0, 1.5]}}


@pytest.mark.parametrize("drop_last", [True, False])
def test_device_batches_match_streaming_loader(drop_last):
    cfg = Config.from_dict(BUCKETS).data
    ds = SynthDataset()
    loader = BucketedLoader(ds, cfg, batch_size=4, drop_last=drop_last)
    batcher = DeviceBatcher(ds, cfg, batch_size=4, drop_last=drop_last, device="cpu")
    assert len(batcher) == len(loader)
    sids = []
    for epoch in (0, 1, 5):
        want = [to_device(b, "cpu") for b in loader.epoch_batches(epoch)]
        got = list(batcher.epoch_batches(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                assert torch.equal(g[k], w[k]), f"epoch {epoch} {k}"
        sids.append(torch.cat([b["sid"] for b in got]))
    assert not torch.equal(sids[0], sids[1])


def test_overlong_clips_cropped_once():
    cfg = Config.from_dict(BUCKETS).data
    ds = SynthDataset(n_items=4, seconds=(2.0, 2.5))  # longer than the 1.5 s top bucket
    batcher = DeviceBatcher(ds, cfg, batch_size=4, device="cpu")
    top = max(bucket_lengths(cfg))
    first = [b["x_wav"] for b in batcher.epoch_batches(0)]
    assert len(first) == 1 and first[0].shape == (4, top)
    # cropped once: the same crop in every epoch (the loader draws anew)
    again = next(iter(batcher.epoch_batches(3)))
    order = [int(s) for s in next(iter(batcher.epoch_batches(0)))["sid"]]
    order3 = [int(s) for s in again["sid"]]
    for row, sid in enumerate(order):
        torch.testing.assert_close(first[0][row], again["x_wav"][order3.index(sid)])
    assert int(again["x_wav_lengths"].max()) == top


def test_estimate_matches_jax():
    ds = SynthDataset()
    cfg, jcfg = Config.from_dict(BUCKETS).data, JaxConfig.from_dict(BUCKETS).data
    assert estimate_corpus_bytes(ds, cfg) == jax_estimate(ds, jcfg) > 0


@pytest.mark.parametrize("fits", [True, False])
def test_auto_gate_picks_each_side(tmp_path, fits):
    from vcvits_tpu_torch.data.dataset import VoiceConversionDataset
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.train.trainer import Trainer

    fl = make_corpus(tmp_path)
    cfg = Config.from_dict(tiny_cfg(tmp_path, fl))
    ds = VoiceConversionDataset(fl, cfg.data)
    est = estimate_corpus_bytes(ds, cfg.data)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, device_cache_max_bytes=est if fits else est - 1))
    tr = Trainer(cfg, workdir=str(tmp_path / "logs"), device="cpu",
                 hubert_cfg=HubertConfig(**TINY_HUBERT))
    loader = tr._maybe_device_cache(ds, BucketedLoader(ds, cfg.data, 2))
    assert isinstance(loader, DeviceBatcher if fits else BucketedLoader)
    np.testing.assert_array_equal(  # the same first batch either way
        next(iter(loader.epoch_batches(0)))["sid"],
        to_device(next(iter(BucketedLoader(ds, cfg.data, 2).epoch_batches(0))), "cpu")["sid"])
