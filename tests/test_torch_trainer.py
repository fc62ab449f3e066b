"""The port's training loop (train/trainer.py) on the CPU, tiny config.

tests/test_trainer.py's corpus and config with `steps_per_epoch` null, so
the schedule's epoch is the loader's: 4 clips at batch 2, 2 steps.
`torch.utils.tensorboard` is replaced by a recording writer (the real
import loads TensorFlow here, several seconds per process), so the tests
read what the logger hands it.

* `fit(max_steps=2)` leaves a checkpoint at 2 through the device batcher
  (the default "auto" gate) and logs its scalars; a new Trainer on the
  workdir restores every tensor as saved and goes on to 3, where the
  learning rate has decayed once, as JAX's schedule with the same epoch
  length gives.
* `TrainStep(steps_per_epoch=...)` and `set_steps_per_epoch` (what the
  Trainer calls with its loader's length) give JAX's schedule; the
  config's `steps_per_epoch` overrides both.
* `request_stop()` before fit, and max_seconds=0, checkpoint step 0.
* SIGTERM to a child process that imports only the port and has no
  tensorboard: after one logged step, a checkpoint, "graceful stop" and
  exit code 0 (the child has its own time limit).
* `validate` returns val/mcd_db >= 0 and 0 <= val/voicing_f1 <= 1 and logs
  the two mel images ([3, n_mels, frames]) and the two clips.
* config.json is written, and `VoiceConverter.from_checkpoint` converts a
  file with the run's config.
* `python -m vcvits_tpu_torch.cli.train` trains in bf16 when the config
  says `"fp16_run": true` (as both shipped configs do) or `--bf16` is
  given, and honours `accumulate_grad_batches` (one k = 2 cycle: two
  mini-steps, one update). Its multi-GPU flags are
  tests/test_torch_parallel*.py's.
"""

import os
import queue
import signal
import subprocess
import sys
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import TINY_HUBERT, make_corpus, tiny_cfg
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.train.state import exponential_epoch_schedule as jax_schedule
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.data.dataset import VoiceConversionDataset
from vcvits_tpu_torch.data.loader import BucketedLoader
from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.train.checkpoint import CheckpointManager
from vcvits_tpu_torch.train.step import TrainStep
from vcvits_tpu_torch.train.trainer import Trainer
from vcvits_tpu_torch.utils.audio_io import read_wav

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUB = HubertConfig(**TINY_HUBERT)


def _cfg(tmp, fl, **train):
    return tiny_cfg(tmp, fl, **{"steps_per_epoch": None, **train})


def _trainer(cfg, workdir):
    return Trainer(Config.from_dict(cfg), workdir=str(workdir), device="cpu", hubert_cfg=HUB)


class RecordingWriter:
    """torch.utils.tensorboard.SummaryWriter's methods the logger calls,
    recorded as (kind, tag, step, value or shape)."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step, value))

    def add_image(self, tag, img, step):
        self.calls.append(("image", tag, step, (np.asarray(img).dtype, np.asarray(img).shape)))

    def add_audio(self, tag, wav, step, sample_rate):
        self.calls.append(("audio", tag, step, (tuple(wav.shape), sample_rate)))

    def flush(self):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def recording_tensorboard():
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = RecordingWriter
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", fake)
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory, recording_tensorboard):
    tmp = tmp_path_factory.mktemp("trainer")
    fl = make_corpus(tmp)
    cfg = _cfg(tmp, fl)
    workdir = tmp / "logs"
    trainer = _trainer(cfg, workdir)
    assert trainer.fit(max_steps=2) == 2
    return tmp, fl, cfg, workdir, trainer


def test_fit_checkpoints_and_resumes(run):
    tmp, fl, cfg, workdir, trainer = run
    assert trainer.loader_kind == "device_cache"
    assert [r["step"] for r in trainer.history] == [1, 2]
    logged = {call[1] for call in trainer.tb._writer.calls
              if call[0] == "scalar" and call[2] == 2}
    assert {"loss/g/total", "loss/d/total", "learning_rate", "steps_per_sec"} <= logged
    ckpt = CheckpointManager(str(workdir / "checkpoints"))
    assert ckpt.latest_step() == 2
    saved = ckpt.restore(2)

    again = _trainer(cfg, workdir)
    assert again.resume_or_init() == 2
    state = again.train_step.state_dict()
    assert state["g_opt"] and state["d_opt"]
    for side in ("gen", "disc"):
        for k, v in saved[side].items():
            assert torch.equal(state[side][k], v), k
    for opt in ("g_opt", "d_opt"):
        assert set(state[opt]) == set(saved[opt])
        for name, moments in saved[opt].items():
            for k, v in moments.items():
                assert torch.equal(state[opt][name][k], v), (opt, name, k)
    assert again.fit(max_steps=3) == 3 and ckpt.latest_step() == 3
    # epoch boundary: step index 2 of 2-step epochs runs at lr0 * lr_decay
    jcfg = JaxConfig.from_dict(cfg)
    lr = float(jnp.asarray(jax_schedule(jcfg, 2)(2), jnp.float32))
    assert lr < jcfg.train.learning_rate
    assert again.train_step.schedule(2) == lr
    assert again.train_step.g_opt.param_groups[0]["lr"] == lr


def test_train_step_takes_steps_per_epoch(run):
    _, _, cfg, _, _ = run
    jcfg = JaxConfig.from_dict(cfg)
    step = TrainStep(Config.from_dict(cfg), device="cpu", hubert_cfg=HUB, steps_per_epoch=3)

    def jax_lrs(c, spe):
        return [float(jnp.asarray(jax_schedule(c, spe)(s), jnp.float32)) for s in range(8)]

    assert [step.schedule(s) for s in range(8)] == jax_lrs(jcfg, 3)
    step.set_steps_per_epoch(5)
    assert [step.schedule(s) for s in range(8)] == jax_lrs(jcfg, 5)
    # the config's epoch length overrides the loader's
    fixed = {**cfg, "train": {**cfg["train"], "steps_per_epoch": 2}}
    step.cfg = Config.from_dict(fixed)
    step.set_steps_per_epoch(5)
    assert [step.schedule(s) for s in range(8)] == jax_lrs(JaxConfig.from_dict(fixed), 5)
    assert jax_lrs(JaxConfig.from_dict(fixed), 5) != jax_lrs(jcfg, 5)


@pytest.mark.parametrize("how", ["request_stop", "max_seconds=0"])
def test_stop_before_the_first_step_saves_step_0(run, tmp_path, how):
    tmp, fl, cfg, _, _ = run
    tr = _trainer(cfg, tmp_path / "logs")
    if how == "request_stop":
        tr.request_stop("test")
        assert tr.fit(max_steps=50) == 0
    else:
        assert tr.fit(max_steps=50, max_seconds=0.0) == 0
    assert CheckpointManager(str(tmp_path / "logs" / "checkpoints")).latest_step() == 0
    assert tr._stop_reason is None and tr.history == []


CHILD = """
import logging, sys
logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(message)s", force=True)
sys.modules["torch.utils.tensorboard"] = None  # as where tensorboard is not installed
import torch
torch.set_num_threads(1)  # as the test processes: many threads crawl beside the other workers
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.train.trainer import Trainer
hub = HubertConfig(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16,
                   num_layers=1, num_heads=2, intermediate_size=32, pos_conv_kernel=8,
                   pos_conv_groups=2)
trainer = Trainer(load_config(sys.argv[1]), workdir=sys.argv[2], device="cpu", hubert_cfg=hub)
print("FIT_RETURNED", trainer.fit(max_steps=10_000), flush=True)
print("JAX_MODULES", [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "vcvits_tpu")])
"""


def test_sigterm_checkpoints_and_exits_cleanly(run, tmp_path):
    import json

    tmp, fl, _, _, _ = run
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg(tmp, fl, log_interval=1, eval_interval=10 ** 6,
                                        checkpoint_interval=10 ** 6)))
    workdir = tmp_path / "logs"
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen([sys.executable, "-c", CHILD, str(cfg_path), str(workdir)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    err = []

    def read():
        for line in proc.stderr:
            err.append(line)
            lines.put(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        while "loss_g=" not in lines.get(timeout=240):  # one logged step, then TERM
            pass
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()
        proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    assert proc.returncode == 0, "".join(err)[-3000:]
    assert "FIT_RETURNED" in out and "JAX_MODULES []" in out
    assert any("graceful stop" in line for line in err)
    step = CheckpointManager(str(workdir / "checkpoints")).latest_step()
    assert step is not None and step >= 1


def test_validate_metrics(run):
    _, fl, cfg, _, trainer = run
    c = Config.from_dict(cfg)
    val = BucketedLoader(VoiceConversionDataset(fl, c.data, shuffle_seed=None), c.data, 2,
                         shuffle=False, drop_last=False)
    _build.LAUNCHES.clear()
    scalars = trainer.validate(val, 7)
    assert scalars["val/mcd_db"] >= 0 and 0.0 <= scalars["val/voicing_f1"] <= 1.0
    assert sum(_build.LAUNCHES.values()) == 0  # the CPU takes the plain versions
    assert trainer.train_step.gen.training
    logged = {call[1]: call[3] for call in trainer.tb._writer.calls if call[2] == 7}
    assert logged["val/mcd_db"] == scalars["val/mcd_db"]
    for tag in ("gen/mel", "gt/mel"):
        dtype, shape = logged[tag]
        assert dtype == np.uint8 and shape[:2] == (3, c.data.n_mel_channels) and shape[2] > 1
    for tag in ("gen/audio", "gt/audio"):
        (one, n), sr = logged[tag]
        assert one == 1 and n > 1000 and sr == c.data.target_sampling_rate


def test_config_json_and_from_checkpoint(run, tmp_path):
    tmp, _, cfg, workdir, _ = run
    assert os.path.exists(workdir / "config.json")
    vc = VoiceConverter.from_checkpoint(str(workdir), device="cpu", hubert_cfg=HUB)
    assert vc.cfg.to_dict() == Config.from_dict(cfg).to_dict()
    out = str(tmp_path / "converted.wav")
    wav = vc.convert(str(tmp / "s0_0.wav"), out, speaker_id=1)
    back, sr = read_wav(out)
    assert sr == 48000 and len(back) == len(wav) > 1000 and np.isfinite(wav).all()
    saved = CheckpointManager(str(workdir / "checkpoints")).restore()
    for k, v in vc.gen.state_dict().items():
        assert torch.equal(v, saved["gen"][k]), k


@pytest.mark.parametrize("extra,fp16_run,k,max_steps", [
    ([], True, 1, 1), (["--bf16"], False, 2, 2)])
def test_cli_trains_bf16_and_accumulates(run, tmp_path, monkeypatch, extra, fp16_run, k,
                                         max_steps):
    """cli.main on the CPU: bf16 from the config's fp16_run or from --bf16,
    `max_steps` mini-steps, one update per k of them, a checkpoint at the
    end. The tiny HuBERT stands in for HuBERT-base (the CLI builds the
    trainer with the configuration's default)."""
    import json

    from vcvits_tpu_torch.cli import train as cli
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.train import trainer as trainer_mod

    tmp, fl, _, _, _ = run
    built = []

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(synthesizer, "hubert_config_for", lambda channels: HUB)
    monkeypatch.setattr(trainer_mod, "Trainer", Recorded)
    cfg = _cfg(tmp, fl, fp16_run=fp16_run)
    cfg["trainer"] = {"accumulate_grad_batches": k}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    workdir = tmp_path / "logs"
    cli.main(["-c", str(cfg_path), "-a", "cpu", "-s", "--workdir", str(workdir),
              "--max-steps", str(max_steps), *extra])
    (trainer,) = built
    step = trainer.train_step
    assert trainer.dtype == step.dtype == torch.bfloat16
    assert step.gen.dtype == torch.bfloat16
    assert (step.step, step.updates, step.mini_step) == (max_steps, max_steps // k, 0)
    assert {float(s["step"]) for s in step.g_opt.state.values()} == {float(max_steps // k)}
    saved = CheckpointManager(str(workdir / "checkpoints")).restore()
    assert saved["step"] == max_steps and saved["accum"]["updates"] == max_steps // k
    assert all(v.dtype == torch.float32 for v in saved["gen"].values())


def test_cli_trains_with_hubert_ckpt(run, tmp_path, monkeypatch):
    """cli.main --hubert-ckpt on the CPU: a synthetic fairseq HuBERT `.pt`
    (convert/export_torch's naming, random weights) is converted into the
    generator's frozen HuBERT, which one training step leaves as loaded;
    the saved checkpoint holds it."""
    import json

    from vcvits_tpu_torch.cli import train as cli
    from vcvits_tpu_torch.convert.hubert_torch import export_hubert_state_dict
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.models.hubert import HubertModel
    from vcvits_tpu_torch.models.layers import init_weights
    from vcvits_tpu_torch.train import trainer as trainer_mod

    tmp, fl, _, _, _ = run
    built = []

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(synthesizer, "hubert_config_for", lambda channels: HUB)
    monkeypatch.setattr(trainer_mod, "Trainer", Recorded)
    want = init_weights(HubertModel(HUB), 123).state_dict()
    ckpt = tmp_path / "hubert_fairseq.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          export_hubert_state_dict(want).items()}}, str(ckpt))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg(tmp, fl, fp16_run=False)))
    workdir = tmp_path / "logs"
    cli.main(["-c", str(cfg_path), "-a", "cpu", "-s", "--workdir", str(workdir),
              "--max-steps", "1", "--hubert-ckpt", str(ckpt)])
    (trainer,) = built
    got = trainer.train_step.gen.enc_p.hubert.state_dict()
    saved = CheckpointManager(str(workdir / "checkpoints")).restore()
    assert trainer.train_step.step == 1
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(saved["gen"][f"enc_p.hubert.{k}"], v), k
