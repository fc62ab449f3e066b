"""The port's command-line tools, on the CPU.

* `python -m vcvits_tpu_torch.cli.infer` on a tiny configuration and a
  written checkpoint, --device cpu: float, --int8-decoder (W8A8) and
  --int8-decoder-mode w8 write 48 kHz files equal to
  `VoiceConverter.convert` in that mode (the int8 ones not equal to the
  float one); the flow-swap mode (--vc-source-sid) and several sources into
  a directory; colliding basenames are refused. The argument parser takes
  every JAX CLI option.
* `cli.filelist` / `cli.split` on a temporary dataset of sine WAVs: the
  lines, speakers and splits equal the JAX package's `generate_filelist` /
  `split_filelist`, and `wav_duration_seconds` equals JAX's.
"""

import json

import numpy as np
import pytest
import torch

from vcvits_tpu.data import filelist as jax_filelist
from vcvits_tpu_torch.data import filelist
from vcvits_tpu_torch.utils.audio_io import read_wav, write_wav

torch.set_num_threads(1)

HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {
    "data": {"n_speakers": 8},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32, "n_heads": 2,
              "n_layers": 1, "hubert_channels": 16, "num_pitch": 64,
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_initial_channel": 32, "gin_channels": 4, "p_dropout": 0.0},
}


def _tone(path, seconds, freq, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    write_wav(str(path), (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32), sr)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory with a checkpoint of a tiny generator (random
    weights, every one non-zero, so that the decoder is audible) and its
    config.json."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    tmp = tmp_path_factory.mktemp("cli")
    model = SynthesizerSVC.from_config(Config.from_dict(CFG), device="cpu", seed=0,
                                       hubert_cfg=HubertConfig(**HUBERT))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    mgr = CheckpointManager(str(tmp / "run" / "checkpoints"))
    mgr.save(5, {"step": 5, "gen": model.state_dict()})
    mgr.wait()
    (tmp / "run" / "config.json").write_text(json.dumps(CFG))
    _tone(tmp / "a.wav", 0.5, 220.0)
    (tmp / "b").mkdir()
    _tone(tmp / "b" / "b.wav", 0.4, 330.0)
    return tmp


@pytest.fixture
def tiny_hubert(monkeypatch):
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.models.hubert import HubertConfig

    monkeypatch.setattr(synthesizer, "hubert_config_for", lambda channels: HubertConfig(**HUBERT))


@pytest.mark.parametrize("args,quant", [([], False), (["--int8-decoder"], True),
                                        (["--int8-decoder", "--int8-decoder-mode", "w8"], "w8")])
def test_cli_infer_converts_in_each_decoder_mode(run_dir, tiny_hubert, args, quant):
    from vcvits_tpu_torch.cli import infer as cli
    from vcvits_tpu_torch.infer import VoiceConverter

    out = run_dir / f"out_{quant}.wav"
    cli.main([str(run_dir / "a.wav"), str(out), "--sid", "3", "--noise-scale", "0",
              "--workdir", str(run_dir / "run"), "--device", "cpu", *args])
    got, sr = read_wav(str(out))
    vc = VoiceConverter.from_checkpoint(str(run_dir / "run"), device="cpu", quant_int8=quant)
    assert vc.gen.dec.quant_int8 == quant
    want = vc.convert(str(run_dir / "a.wav"), str(run_dir / f"want_{quant}.wav"), 3,
                      noise_scale=0.0)
    assert sr == 48000 and got.shape == want.shape and np.abs(want).mean() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)  # PCM_24 rounding
    if quant:
        flt = VoiceConverter.from_checkpoint(str(run_dir / "run"), device="cpu").convert(
            str(run_dir / "a.wav"), str(run_dir / "flt.wav"), 3, noise_scale=0.0)
        assert not np.array_equal(want, flt)


def test_cli_infer_flow_swap_and_many_sources(run_dir, tiny_hubert):
    from vcvits_tpu_torch.cli import infer as cli

    out_dir = run_dir / "many"
    cli.main([str(run_dir / "a.wav"), str(run_dir / "b" / "b.wav"), str(out_dir), "--sid", "2",
              "--workdir", str(run_dir / "run"), "--device", "cpu",
              "--int8-decoder-mode", "w8"])
    for name, seconds in (("a.wav", 0.5), ("b.wav", 0.4)):
        y, sr = read_wav(str(out_dir / name))
        assert sr == 48000 and abs(len(y) - seconds * 48000) <= 7680 and np.isfinite(y).all()
    swap = run_dir / "swap.wav"
    cli.main([str(run_dir / "a.wav"), str(swap), "--sid", "5", "--vc-source-sid", "1",
              "--workdir", str(run_dir / "run"), "--device", "cpu", "--int8-decoder"])
    y, sr = read_wav(str(swap))
    assert sr == 48000 and len(y) > 0 and np.isfinite(y).all()
    with pytest.raises(SystemExit, match="basename"):
        cli.main([str(run_dir / "a.wav"), str(run_dir / "a.wav"), str(out_dir),
                  "--workdir", str(run_dir / "run"), "--device", "cpu"])


def test_cli_infer_takes_the_jax_options():
    from vcvits_tpu_torch.cli import infer as cli

    args = cli.parse_args(["s.wav", "o.wav", "--sid", "7", "--vc-source-sid", "2",
                           "--pitch-shift", "-3", "--noise-scale", "0.5", "--workdir", "w",
                           "-c", "c.json", "--int8-decoder", "--int8-decoder-mode", "w8"])
    assert (args.sid, args.vc_source_sid, args.pitch_shift, args.noise_scale) == (7, 2, -3, 0.5)
    assert cli.quant_mode(args) == "w8" and args.device == "cuda"


@pytest.fixture
def dataset(tmp_path):
    root = tmp_path / "dataset"
    for s, (name, n) in enumerate((("alice", 4), ("bob", 3), ("carol", 2))):
        (root / name).mkdir(parents=True)
        for i in range(n):
            _tone(root / name / f"{i}.wav", 0.3 + 0.1 * i, 200.0 + 50 * s, sr=8000)
        _tone(root / name / "short.wav", 0.1, 300.0, sr=8000)
    (root / "notes.txt").write_text("not a speaker")
    return root


def test_cli_filelist_and_split_match_jax(dataset, tmp_path):
    from vcvits_tpu_torch.cli import filelist as cli_filelist
    from vcvits_tpu_torch.cli import split as cli_split

    out = tmp_path / "lists" / "audio.txt"
    cli_filelist.main(["--dataset", str(dataset), "--out", str(out), "--min-files", "2",
                       "--min-seconds", "0.25"])
    lines = out.read_text().splitlines()
    want, speakers = jax_filelist.generate_filelist(str(dataset), 2, 0.25)
    assert lines == want and len(lines) == 7
    assert (tmp_path / "lists" / "audio_speakers.txt").read_text().splitlines() == speakers \
        == ["alice", "bob"]
    for p in (dataset / "alice" / "1.wav", dataset / "bob" / "short.wav", dataset / "notes.txt"):
        assert filelist.wav_duration_seconds(str(p)) == jax_filelist.wav_duration_seconds(str(p))
    cli_split.main(["--filelist", str(out), "--n-valid", "2", "--n-test", "1"])
    splits = [(tmp_path / "lists" / f"audio_{n}.txt").read_text().splitlines()
              for n in ("train", "valid", "test")]
    assert tuple(splits) == jax_filelist.split_filelist(lines, 1234, 2, 1)
    assert [len(s) for s in splits] == [4, 2, 1]
    assert filelist.split_filelist(lines, 7, 1, 1) == jax_filelist.split_filelist(lines, 7, 1, 1)
