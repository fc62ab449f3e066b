"""Checkpoints of the port's train state (train/checkpoint.py).

* Save and restore round trip, after one step so both AdamW states hold
  moments: every weight, moment and the step come back bit-equal.
* The shape-tolerant restore after `n_speakers` changes keeps the fresh
  `emb_g`, restores every other weight, resets both optimizers and the
  step, and reports `changed`; an exact restore reports no change.
* An incomplete step directory (no state file, or a temporary name) is
  not a checkpoint; `max_to_keep` holds.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_data import TINY_HUBERT
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from vcvits_tpu_torch.train.step import TrainStep

torch.set_num_threads(1)

CFG = {"train": {"segment_size": 2048, "batch_size": 2, "steps_per_epoch": 10,
                 "disc_time_fold": False},
       "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
                "n_mel_channels": 8, "n_speakers": 4},
       "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
                 "n_heads": 2, "n_layers": 1, "hubert_channels": 16, "num_pitch": 64,
                 "gin_channels": 4, "upsample_initial_channel": 32,
                 "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
                 "multi_period_discriminator_periods": [2]}}


def _step(cfg=None, seed=0):
    return TrainStep(cfg or Config.from_dict(CFG), device="cpu",
                     hubert_cfg=HubertConfig(**TINY_HUBERT), seed=seed)


def _batch():
    g = np.random.default_rng(0)
    return {"x_wav": torch.tensor(g.standard_normal((2, 5120)) * 0.1, dtype=torch.float32),
            "x_wav_lengths": torch.tensor([5120, 4480], dtype=torch.int32),
            "x_pitch": torch.tensor(g.integers(1, 64, (2, 16))),
            "y_wav": torch.tensor(g.standard_normal((2, 15360)) * 0.1, dtype=torch.float32),
            "y_wav_lengths": torch.tensor([15360, 13312], dtype=torch.int32),
            "sid": torch.tensor([1, 3])}


@pytest.fixture(scope="module")
def trained():
    step = _step()
    step(_batch())
    return step


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), path
    else:
        assert got == want, path


def test_round_trip_is_exact(trained, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, trained.state_dict())
    mgr.wait()
    assert mgr.latest_step() == 1 and set(mgr.timings) == {"blocking_s", "write_s"}
    other = _step(seed=5)
    state, changed = mgr.restore_tolerant(other.state_dict())
    assert not changed
    other.load_state_dict(state)
    want = trained.state_dict()
    assert want["step"] == 1 and want["g_opt"] and want["d_opt"]
    _assert_tree_equal(other.state_dict(), want)


def test_tolerant_restore_after_speaker_change(trained, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, trained.state_dict())
    cfg = Config.from_dict(CFG)
    fresh = _step(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_speakers=6)),
                  seed=5)
    mgr.wait()
    template = fresh.state_dict()
    fresh_emb = template["gen"]["emb_g.weight"].clone()
    state, changed = mgr.restore_tolerant(template)
    assert changed and state["step"] == 0 and not state["g_opt"] and not state["d_opt"]
    fresh.load_state_dict(state)
    got = fresh.state_dict()
    assert torch.equal(got["gen"]["emb_g.weight"], fresh_emb)
    saved = trained.state_dict()
    for side in ("gen", "disc"):
        for k, v in saved[side].items():
            if k != "emb_g.weight":
                assert torch.equal(got[side][k], v), k
    assert fresh.step == 0 and not fresh.g_opt.state and not fresh.d_opt.state


def test_incomplete_step_directories_are_ignored(trained, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"step": 4, "gen": {}, "disc": {}, "g_opt": {}, "d_opt": {}})
    mgr.wait()
    os.makedirs(tmp_path / "9")  # a step directory without its file
    os.makedirs(tmp_path / ".12.tmp1")  # an unfinished write
    (tmp_path / ".12.tmp1" / STATE_FILE).write_bytes(b"partial")
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    assert CheckpointManager(str(tmp_path)).restore()["step"] == 4


def test_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in (1, 2, 5, 7, 8):
        mgr.save(s, {"step": s, "w": torch.full((3,), float(s))})
    mgr.wait()
    assert mgr.all_steps() == [5, 7, 8]
    assert torch.equal(mgr.restore(7)["w"], torch.full((3,), 7.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
