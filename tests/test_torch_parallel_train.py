"""The port's multi-GPU training paths on spawned CPU ranks (gloo, one
thread a rank, a file store; tests/torch_parallel_ranks.py): the loop,
the TTS step, the CLIs under a process group, and the dry run.

* A DP2 x TP2 `Trainer.fit` of 2 steps on tests/test_trainer.py's corpus,
  then, in fresh process groups of two ranks, resumes at TP = 1 (DP2) and
  TP = 2: every restored tensor equals the checkpoint, and each goes on
  one step.
* A DP = 2 TTS step whose two ranks hold texts of unequal lengths (so the
  global sum(x_mask) sets both ranks' duration loss) against the
  one-process step on the same batch and injected global draws: every
  metric and gradient as in tests/test_torch_parallel.py.
* `cli.train --distributed --model-parallel 2` and `cli.train_tts
  --distributed` under two ranks, as under torchrun.
* `dryrun_multigpu(2)`.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from vcvits_tpu_torch.parallel.dryrun import dryrun_multigpu, launch

torch.set_num_threads(1)


def test_fit_then_resume_at_other_layouts(tmp_path):
    from tests.test_torch_data import make_corpus, tiny_cfg

    fl = make_corpus(tmp_path)
    cfg = tiny_cfg(tmp_path, fl, steps_per_epoch=None)
    try:
        rec = launch(ranks.fit_layouts, 4, cfg, str(tmp_path / "logs"), str(tmp_path),
                     workdir=str(tmp_path))[0]
    finally:
        shutil.rmtree(tmp_path / "logs", ignore_errors=True)  # 0.6 GB checkpoints
    assert rec["layout0"] == (2, 2) and rec["fit0"] == 2
    assert rec["resume_tp1"] == {"layout": (2, 1), "from": 2, "max_abs_diff": 0.0, "fit": 3}
    assert rec["resume_tp2"] == {"layout": (1, 2), "from": 3, "max_abs_diff": 0.0, "fit": 4}


def test_tts_dp2_step_with_unequal_lengths(tmp_path):
    from tests.test_torch_tts_train import CFG, N_VOCAB, tts_batch

    batch = tts_batch()
    assert batch["text_lengths"][0] != batch["text_lengths"][1]  # one row a rank
    g = np.random.default_rng(4)
    b, t_x = batch["text"].shape
    t_y = batch["y_wav"].shape[1] // CFG["data"]["hop_length"]
    seg = CFG["train"]["segment_size"] // CFG["data"]["hop_length"]
    draws = {"eps": g.standard_normal((b, t_y, CFG["model"]["inter_channels"])).astype(
                 np.float32),
             "e_q": g.standard_normal((b, t_x, 2)).astype(np.float32),
             "ids_str": np.array([3, 10], np.int32)}
    assert (draws["ids_str"] <= batch["y_wav_lengths"] // 512 - seg).all()
    got = launch(ranks.tts_step, 2, CFG, batch, draws, N_VOCAB, workdir=str(tmp_path))[0]

    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.data.loader import to_device
    from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep

    step = TTSTrainStep(Config.from_dict(CFG), device="cpu", seed=0, n_vocab=N_VOCAB)
    metrics = step(to_device(batch, "cpu"),
                   TTSStepDraws(**{k: torch.as_tensor(v) for k, v in draws.items()}))
    grads = {f"{s}.{k}": p.grad.clone() for s, m in (("g", step.gen), ("d", step.disc))
             for k, p in m.named_parameters() if p.grad is not None}
    ranks.assert_step_close(got, ({k: float(v) for k, v in metrics.items()}, grads))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.test_torch_data import make_corpus, tiny_cfg

    tmp = tmp_path_factory.mktemp("cli_corpus")
    fl = make_corpus(tmp)
    return tmp, tiny_cfg(tmp, fl, steps_per_epoch=None)


def test_cli_train_distributed_model_parallel(corpus, tmp_path):
    _, cfg = corpus
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({**cfg, "train": {**cfg["train"], "fp16_run": False}}))
    argv = ["-c", str(cfg_path), "-a", "cpu", "-s", "--workdir", str(tmp_path / "logs"),
            "--max-steps", "1", "--distributed", "--model-parallel", "2"]
    try:
        res = launch(ranks.cli_train, 2, argv, workdir=str(tmp_path))
        assert res[0] == res[1]
        assert res[0]["layout"] == (1, 2) and res[0]["step"] == 1 and res[0]["sharded"] > 0
        assert os.path.isdir(tmp_path / "logs" / "checkpoints" / "1")
    finally:
        shutil.rmtree(tmp_path / "logs", ignore_errors=True)  # a 0.6 GB checkpoint


def test_cli_train_tts_distributed(tmp_path):
    from tests.test_torch_infer_tts import make_tts_corpus, tts_config

    fl = make_tts_corpus(tmp_path)
    cfg = tts_config(tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({**cfg, "train": {**cfg["train"], "fp16_run": False}}))
    argv = ["-c", str(cfg_path), "--filelist", fl, "--workdir", str(tmp_path / "logs"),
            "--max-steps", "1", "--device", "cpu", "--distributed"]
    try:
        res = launch(ranks.cli_train_tts, 2, argv, workdir=str(tmp_path))
        assert res == [{"data": 2, "step": 1}] * 2
        assert os.path.isdir(tmp_path / "logs" / "checkpoints" / "1")
    finally:
        shutil.rmtree(tmp_path / "logs", ignore_errors=True)  # a 0.6 GB checkpoint


def test_dryrun_multigpu(tmp_path):
    rec = dryrun_multigpu(2, workdir=str(tmp_path))
    assert rec["backend"] == "gloo" and rec["layout"] == [1, 2]
    assert rec["restore_layout"] == [2, 1]
