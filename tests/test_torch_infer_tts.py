"""TTS synthesis and the TTS training loop in the port, on the CPU:
TTSSynthesizer against JAX's on shared weights (noise 0), its text
bucketing and frame budget, the empty-text refusal, TTSTrainer's fit,
resume, checkpoints, validation and synthesize, TTSSynthesizer.
from_checkpoint on the trainer's workdir, and both CLIs
(`cli.train_tts`, `cli.infer_tts`).

tests/test_infer_tts.py's tiny configuration with the text front end's
whole vocabulary. `torch.utils.tensorboard` is replaced by the recording
writer of tests/test_torch_trainer.py. The waveform against JAX's to atol
1e-4 (float32, TF32 off), lengths and alignments exactly.
"""

import json
import os
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import RecordingWriter
from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.infer_tts import TTSSynthesizer as JaxTTSSynthesizer
from vcvits_tpu.train.tts_step import build_tts_models
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.infer_tts import TTSSynthesizer
from vcvits_tpu_torch.utils.audio_io import read_wav, write_wav

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = {
    "train": {"segment_size": 2048, "batch_size": 2, "fp16_run": False, "log_interval": 1,
              "eval_interval": 2, "checkpoint_interval": 2, "steps_per_epoch": 10},
    "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "gin_channels": 4,
              "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]], "multi_period_discriminator_periods": [2, 3]},
}
TEXT = "Hello world, this is a test."


@pytest.fixture(scope="module")
def synths():
    """JAX's TTSSynthesizer and the port's on the same random weights."""
    jcfg = JaxConfig.from_dict(TINY)
    gen, _, _ = build_tts_models(jcfg)
    shapes = jax.eval_shape(lambda: gen.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        np.zeros((1, 8), np.int32), np.array([8]),
        np.zeros((1, 12, jcfg.data.spec_channels), np.float32), np.array([12]),
        np.array([0])))["params"]
    rng = np.random.default_rng(0)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 25
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    kw = dict(text_unit=16, frames_per_token=4)
    return (JaxTTSSynthesizer(jcfg, params, **kw),
            TTSSynthesizer.from_params(Config.from_dict(TINY), params, device="cpu", **kw))


@pytest.mark.parametrize("length_scale", [1.0, 1.6])
def test_synthesize_matches_jax_at_noise_zero(synths, length_scale):
    jax_tts, tts = synths
    kw = dict(sid=2, noise_scale=0.0, noise_scale_w=0.0, length_scale=length_scale,
              return_alignment=True)
    want, want_attn = jax_tts.synthesize(TEXT, **kw)
    got, attn = tts.synthesize(TEXT, **kw)
    np.testing.assert_array_equal(attn, np.asarray(want_attn))
    assert got.shape == want.shape and len(got) % 512 == 0 and len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_text_front_end_and_bucketing(synths):
    """encode_text as JAX's (with and without blanks); the ids padded to the
    next multiple of text_unit; the frame budget frames_per_token x padded
    x max(1, length_scale), or max_frames."""
    jax_tts, tts = synths
    for text in (TEXT, "Dr. Smith paid $12 on May 3rd.", "hi"):
        np.testing.assert_array_equal(tts.encode_text(text), jax_tts.encode_text(text))
    n = len(tts.encode_text(TEXT))
    padded = int(np.ceil(n / 16) * 16)
    assert tts.frame_budget(n) == 4 * padded
    assert tts.frame_budget(n, length_scale=1.6) == int(np.ceil(4 * padded * 1.6))
    assert tts.frame_budget(n, length_scale=0.5, max_frames=33) == 33
    _, attn = tts.synthesize(TEXT, return_alignment=True, max_frames=40, seed=3)
    assert attn.shape == (40, padded)
    w1, w2 = tts.synthesize("abc", seed=1), tts.synthesize("abc", seed=1)
    np.testing.assert_array_equal(w1, w2)  # deterministic per seed
    assert not np.array_equal(w1, tts.synthesize("abc", seed=2))
    blank = TTSSynthesizer(tts.cfg, tts.gen.state_dict(), device="cpu", add_blank=True)
    seq = blank.encode_text("ab")
    assert list(seq[::2]) == [0, 0, 0] and list(seq[1::2]) == list(tts.encode_text("ab"))


def test_bf16_synthesis_on_cpu(synths):
    """bfloat16 compute (the SDP stays float32): finite, trimmed to its
    frames, within a frame a token of the float32 length at noise 0."""
    _, tts = synths
    b16 = TTSSynthesizer(tts.cfg, tts.gen.state_dict(), device="cpu", dtype=torch.bfloat16,
                         text_unit=16, frames_per_token=4)
    kw = dict(sid=1, noise_scale=0.0, noise_scale_w=0.0)
    got, want = b16.synthesize(TEXT, **kw), tts.synthesize(TEXT, **kw)
    assert got.dtype == np.float32 and np.isfinite(got).all() and len(got) % 512 == 0
    assert abs(len(got) - len(want)) <= 512 * len(tts.encode_text(TEXT))


def test_empty_text_raises(synths):
    _, tts = synths
    with pytest.raises(ValueError, match="empty"):
        tts.encode_text("")
    with pytest.raises(ValueError, match="empty"):
        tts.synthesize("")


# ------------------------------------------------------------ the TTS loop
@pytest.fixture(scope="module")
def recording_tensorboard():
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = RecordingWriter
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", fake)
        yield


def make_tts_corpus(root, n=4):
    """n 0.4-0.7 s sines at 22.05 kHz with a line of text each."""
    rng = np.random.default_rng(1)
    lines = []
    for i in range(n):
        sr, sec = 22050, 0.4 + 0.1 * i
        t = np.arange(int(sr * sec)) / sr
        wav = 0.3 * np.sin(2 * np.pi * (150 + 30 * i) * t) + 0.01 * rng.standard_normal(t.size)
        path = root / f"utt{i}.wav"
        write_wav(str(path), wav.astype(np.float32), sr)
        lines.append(f"{path}|{i % 4}|Sentence number {i} is spoken here.")
    fl = root / "tts_train.txt"
    fl.write_text("\n".join(lines) + "\n")
    return str(fl)


def tts_config(root):
    cfg = json.loads(json.dumps(TINY))
    cfg["data"]["cache_dir"] = str(root / "cache")
    return cfg


@pytest.fixture(scope="module")
def loop(tmp_path_factory, recording_tensorboard):
    """fit to 2 (a validation and a checkpoint at 2), then a second trainer
    resumes and fits to 4 with a validation that raises (at 4). The
    checkpoints (about 0.6 GB each: the discriminators and both AdamWs)
    are removed at the end of the module."""
    from vcvits_tpu_torch.train.tts_trainer import TTSTrainer

    root = tmp_path_factory.mktemp("tts_loop")
    fl = make_tts_corpus(root)
    cfg = Config.from_dict(tts_config(root))
    workdir = root / "run"
    trainer = TTSTrainer(cfg, workdir=str(workdir), device="cpu", text_bucket=48,
                         audio_seconds=0.5)
    end = trainer.fit(fl, max_steps=2)
    saved = trainer.ckpt.restore(2)
    resumed = TTSTrainer(cfg, workdir=str(workdir), device="cpu", text_bucket=48,
                         audio_seconds=0.5)
    start = resumed.resume_or_init()
    restored = {k: v.clone() for k, v in resumed.train_step.gen.state_dict().items()}
    failed = []

    def boom(step_no, *a, **k):
        failed.append(step_no)
        raise RuntimeError("validation failed")

    resumed.log_validation = boom
    end2 = resumed.fit(fl, max_steps=4)
    yield root, fl, workdir, trainer, end, saved, resumed, start, restored, end2, failed
    shutil.rmtree(root, ignore_errors=True)


def test_fit_logs_validates_and_checkpoints(loop):
    root, fl, workdir, trainer, end, saved, *_ = loop
    assert end == 2 and trainer.ckpt.all_steps() == [2, 4]  # 4: the resumed run's
    assert json.loads((workdir / "config.json").read_text())["model"]["hidden_channels"] == 16
    calls = trainer.tb._writer.calls
    steps = sorted({c[2] for c in calls if c[0] == "scalar" and c[1] == "loss/g/dur"})
    assert steps == [1, 2]
    assert {c[1] for c in calls if c[0] == "image"} == {"val/alignment", "val/mel"}
    assert [c[1] for c in calls if c[0] == "audio"] == ["val/audio"]
    assert all(np.isfinite(c[3]) for c in calls if c[0] == "scalar")
    assert saved["step"] == 2 and set(saved) >= {"gen", "disc", "g_opt", "d_opt"}


def test_fit_logs_steps_per_sec(loop):
    """steps/s from a StepTimer beside the other scalars at each log
    interval, once the timer has two ticks (JAX's tts_trainer.py)."""
    trainer, resumed = loop[3], loop[6]
    for tr, steps in ((trainer, [2]), (resumed, [4])):
        sps = [c for c in tr.tb._writer.calls if c[0] == "scalar" and c[1] == "steps_per_sec"]
        assert [c[2] for c in sps] == steps and all(c[3] > 0 for c in sps)


def test_resume_restores_and_continues(loop):
    """The resumed trainer starts from the saved tensors, and a validation
    that raises (at step 4) is logged while training goes on."""
    *_, saved, resumed, start, restored, end2, failed = loop
    assert start == 2 and end2 == 4 and failed == [4]
    for k, v in saved["gen"].items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0, msg=k)
    assert resumed.ckpt.latest_step() == 4


def test_trainer_synthesize(loop):
    root, fl, workdir, trainer, *_ = loop
    wav, attn = trainer.synthesize("Hello there.", sid=1, max_frames=64,
                                   return_alignment=True)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    assert 0 < len(wav) <= 64 * 512 and len(wav) % 512 == 0
    assert attn.shape[0] == 64 and attn.sum() == len(wav) // 512


def test_from_checkpoint_of_the_trainer(loop, tmp_path):
    root, fl, workdir, *_ = loop
    tts = TTSSynthesizer.from_checkpoint(str(workdir), device="cpu", text_unit=16,
                                         frames_per_token=4)
    assert tts.cfg.model.hidden_channels == 16
    out = tts.synthesize_to_file(TEXT, str(tmp_path / "o.wav"), sid=1)
    data, sr = read_wav(out)
    assert sr == 48000 and 0 < len(data) <= 4 * 32 * 512
    with pytest.raises(FileNotFoundError, match="config.json"):
        empty = tmp_path / "no_config"
        (empty / "checkpoints").mkdir(parents=True)
        os.symlink(workdir / "checkpoints" / "4", empty / "checkpoints" / "4")
        TTSSynthesizer.from_checkpoint(str(empty), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TTSSynthesizer.from_checkpoint(str(tmp_path / "nothing"), device="cpu")


def test_cli_train_tts_and_infer_tts(loop, tmp_path):
    from vcvits_tpu_torch.cli import infer_tts as cli_infer
    from vcvits_tpu_torch.cli import train_tts as cli_train

    root, fl, *_ = loop
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(tts_config(root)))
    wd = tmp_path / "cli_run"
    try:
        run_both_clis(cli_train, cli_infer, cfg_path, fl, wd, tmp_path)
    finally:
        shutil.rmtree(wd, ignore_errors=True)  # a 0.6 GB checkpoint


def run_both_clis(cli_train, cli_infer, cfg_path, fl, wd, tmp_path):
    cli_train.main(["-c", str(cfg_path), "--filelist", fl, "--workdir", str(wd),
                    "--max-steps", "1", "--device", "cpu"])
    assert (wd / "checkpoints" / "1" / "state.pt").exists()
    out = tmp_path / "one.wav"
    cli_infer.main(["Good morning.", str(out), "--workdir", str(wd), "--device", "cpu",
                    "--max-frames", "48", "--sid", "2"])
    data, sr = read_wav(str(out))
    assert sr == 48000 and 0 < len(data) <= 48 * 512
    lines = tmp_path / "lines.txt"
    lines.write_text("# a comment\nFirst line.\n\nSecond line.\n")
    cli_infer.main(["Zeroth.", str(tmp_path / "many"), "--text-file", str(lines),
                    "--workdir", str(wd), "--device", "cpu", "--max-frames", "32"])
    assert sorted(os.listdir(tmp_path / "many")) == [f"utt_000{i}.wav" for i in range(3)]


def test_cli_options_are_jax_options():
    from vcvits_tpu_torch.cli import infer_tts as cli_infer
    from vcvits_tpu_torch.cli import train_tts as cli_train

    _, args = cli_infer.parse_args(["t", "o.wav"])
    assert (args.noise_scale, args.noise_scale_w, args.length_scale) == (0.667, 0.8, 1.0)
    assert args.device == "cuda" and args.workdir == "logs_tts" and not args.add_blank
    assert args.cleaners == ["english_cleaners"]
    args = cli_train.parse_args(["--filelist", "f.txt", "--add-blank", "--bf16"])
    assert args.config == "configs/48k_base.json" and args.device == "cuda"
    assert args.add_blank and args.bf16 and args.workdir == "logs_tts"
