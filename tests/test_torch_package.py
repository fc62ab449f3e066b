"""Guards of the PyTorch port's package boundary and device rules.

* No module under vcvits_tpu_torch/, and not chip_smoke.py or
  tools/torch_convergence_run.py, imports jax, flax, optax, orbax or
  vcvits_tpu.
* Importing the package, its trainer, data pipeline, metrics, serving and
  streaming modules, converters, the int8 conv, the TTS path (text front
  end, models, MAS, synthesis, train step, trainer, dataset) and CLIs
  loads no JAX.
* Entry points (conversion, flow-swap conversion, the train step, the
  trainer, the device batcher, the metrics, loading a checkpoint, the
  HuBERT feature dump, the serving CLI with and without the int8 decoder,
  the inference CLI; TTS synthesis and its checkpoint loader, the TTS
  model, train step and trainer, both TTS CLIs) refuse to run on the CPU
  unless asked to.
* On CPU tensors the kernel wrappers take their plain versions and count
  no launch; K3's wrapper refuses an input that requires grad.
* The port's config loads the repo's JSON configs exactly as JAX's does.
"""

import ast
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from vcvits_tpu.config import load_config as jax_load_config
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.flow_coupling import coupling_reverse, coupling_reverse_plain
from vcvits_tpu_torch.ops.fused_gate import fused_add_tanh_sigmoid_multiply, fused_gate
from vcvits_tpu_torch.ops.int8_conv import (
    conv1d_w8a8, conv1d_w8a8_plain, prepare_w8a8, row_absmax, row_absmax_plain)
from vcvits_tpu_torch.ops.monotonic_align import length_mask, maximum_path, maximum_path_plain
from vcvits_tpu_torch.ops.mrf import mrf, mrf_plain
from vcvits_tpu_torch.ops.stft_mel import (
    spectrogram, spectrogram_mel, spectrogram_mel_plain, spectrogram_plain)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vcvits_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "orbax", "vcvits_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "torch_convergence_run.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    bad = [f"{os.path.relpath(path, ROOT)}: {mod}" for path in paths for mod in _imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_loads_no_jax():
    code = ("import sys, vcvits_tpu_torch, vcvits_tpu_torch.infer, "
            "vcvits_tpu_torch.convert.from_jax, vcvits_tpu_torch.train.step, "
            "vcvits_tpu_torch.train.trainer, vcvits_tpu_torch.eval, vcvits_tpu_torch.cli.train, "
            "vcvits_tpu_torch.data.filelist, vcvits_tpu_torch.data.collate, "
            "vcvits_tpu_torch.data.dataset, vcvits_tpu_torch.data.loader, "
            "vcvits_tpu_torch.data.device_cache, vcvits_tpu_torch.data.preload, "
            "vcvits_tpu_torch.serving, vcvits_tpu_torch.streaming, "
            "vcvits_tpu_torch.streaming_conv, vcvits_tpu_torch.cli.serve, "
            "vcvits_tpu_torch.cli.infer, vcvits_tpu_torch.cli.filelist, "
            "vcvits_tpu_torch.cli.split, vcvits_tpu_torch.cli.convert_checkpoint, "
            "vcvits_tpu_torch.convert.vcvits_torch, vcvits_tpu_torch.convert.export_torch, "
            "vcvits_tpu_torch.convert.hubert_torch, vcvits_tpu_torch.ops.int8_conv, "
            "vcvits_tpu_torch.text, vcvits_tpu_torch.models.synthesizer_tts, "
            "vcvits_tpu_torch.ops.monotonic_align, vcvits_tpu_torch.infer_tts, "
            "vcvits_tpu_torch.train.tts_step, vcvits_tpu_torch.train.tts_trainer, "
            "vcvits_tpu_torch.data.tts_dataset, vcvits_tpu_torch.cli.infer_tts, "
            "vcvits_tpu_torch.cli.train_tts, vcvits_tpu_torch.models.classic_transformer, "
            "vcvits_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'vcvits_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_cpu_by_default(monkeypatch, tmp_path):
    from vcvits_tpu_torch.cli import infer as infer_cli
    from vcvits_tpu_torch.cli import serve as serve_cli
    from vcvits_tpu_torch.data.device_cache import DeviceBatcher
    from vcvits_tpu_torch.data.preload import dump_hubert_features
    from vcvits_tpu_torch.eval import evaluate_pair
    from vcvits_tpu_torch.cli import infer_tts as infer_tts_cli
    from vcvits_tpu_torch.cli import train_tts as train_tts_cli
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.infer_tts import TTSSynthesizer
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC
    from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS
    from vcvits_tpu_torch.train.step import TrainStep
    from vcvits_tpu_torch.train.trainer import Trainer
    from vcvits_tpu_torch.train.tts_step import TTSTrainStep
    from vcvits_tpu_torch.train.tts_trainer import TTSTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(ROOT, "configs", "48k_base.json"))
    wav = np.zeros(48000, np.float32)
    # VoiceConverter carries both convert and the flow-swap voice_conversion
    for build in (lambda: VoiceConverter(cfg), lambda: SynthesizerSVC.from_config(cfg),
                  lambda: TrainStep(cfg), lambda: Trainer(cfg, workdir=str(tmp_path)),
                  lambda: DeviceBatcher([], cfg.data, 2),
                  lambda: evaluate_pair(wav, wav, 48000),
                  lambda: VoiceConverter.from_checkpoint(str(tmp_path)),
                  lambda: dump_hubert_features([], cfg, torch.nn.Linear(1, 1)),
                  lambda: serve_cli.main(["--workdir", str(tmp_path)]),
                  lambda: serve_cli.main(["--workdir", str(tmp_path), "--int8-decoder"]),
                  lambda: infer_cli.main(["in.wav", "out.wav", "--workdir", str(tmp_path)]),
                  lambda: TTSSynthesizer(cfg), lambda: SynthesizerTTS.from_config(cfg),
                  lambda: TTSTrainStep(cfg), lambda: TTSTrainer(cfg, workdir=str(tmp_path)),
                  lambda: TTSSynthesizer.from_checkpoint(str(tmp_path)),
                  lambda: infer_tts_cli.main(["Hi.", "out.wav", "--workdir", str(tmp_path)]),
                  lambda: train_tts_cli.main(["-c", os.path.join(ROOT, "configs",
                                                                  "48k_base.json"),
                                              "--filelist", "f.txt",
                                              "--workdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_voice_conversion_and_train_step_run_on_cpu_when_asked(monkeypatch):
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.train.step import TrainStep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hub = HubertConfig(conv_layers=((8, 10, 5), (8, 8, 8), (8, 8, 8)), hidden_size=8,
                       num_layers=1, num_heads=2, intermediate_size=16, pos_conv_kernel=8,
                       pos_conv_groups=2)
    cfg = Config.from_dict({
        "train": {"segment_size": 1024},
        "data": {"filter_length": 512, "win_length": 512, "hop_length": 256,
                 "n_mel_channels": 8, "n_speakers": 4},
        "model": {"inter_channels": 4, "hidden_channels": 8, "filter_channels": 16,
                  "n_heads": 2, "n_layers": 1, "hubert_channels": 8, "num_pitch": 16,
                  "gin_channels": 4, "upsample_initial_channel": 16,
                  "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 4],
                  "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
                  "multi_period_discriminator_periods": [2]}})
    vc = VoiceConverter(cfg, device="cpu", hubert_cfg=hub)
    assert vc.voice_conversion_array(np.zeros(8000, np.float32), 1, 2).shape == (7936,)
    step = TrainStep(cfg, device="cpu", hubert_cfg=hub)
    g = np.random.default_rng(0)
    batch = {"x_wav": torch.tensor(g.standard_normal((2, 2560)) * 0.1, dtype=torch.float32),
             "x_wav_lengths": torch.tensor([2560, 2000]),
             "x_pitch": torch.tensor(g.integers(1, 16, (2, 8))),
             "y_wav": torch.tensor(g.standard_normal((2, 7680)) * 0.1, dtype=torch.float32),
             "y_wav_lengths": torch.tensor([7680, 6000]), "sid": torch.tensor([0, 3])}
    _build.LAUNCHES.clear()
    metrics = step(batch)
    assert all(torch.isfinite(v) for v in metrics.values()) and step.step == 1
    assert sum(_build.LAUNCHES.values()) == 0


def test_k3_wrapper_refuses_grad():
    y = torch.zeros(1, 4096, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        spectrogram_mel(y, 2048, 128, 48000, 512, 2048)
    with pytest.raises(ValueError, match="no backward"):
        spectrogram(y, 2048, 512, 2048)


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    _build.LAUNCHES.clear()
    c, ks, ds = 8, (3,), ((1, 2),)
    x = torch.tensor(rng.standard_normal((1, 20, c)), dtype=torch.float32)
    blk = tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                for s in ((2, 3, c, c), (2, c), (2, 3, c, c), (2, c)))
    assert torch.equal(mrf(x, [blk], ks, ds), mrf_plain(x, [blk], ks, ds))

    h, half, n = 4, 2, 4
    w = tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32)
              for s in ((half, h), (h,), (n, 5, h, 2 * h), (n, 2 * h), (n, h, 2 * h),
                        (n, 2 * h), (h, half), (half,)))
    xf = torch.tensor(rng.standard_normal((1, 20, 2 * half)), dtype=torch.float32)
    mask = torch.ones(1, 20, 1)
    assert torch.equal(coupling_reverse(xf, mask, None, w),
                       coupling_reverse_plain(xf, mask, None, w))

    y = torch.tensor(rng.standard_normal((2, 3000)), dtype=torch.float32)
    spec, mel = spectrogram_mel(y, 512, 8, 16000, 128, 512)
    ref_spec, ref_mel = spectrogram_mel_plain(y, 512, 8, 16000, 128, 512)
    assert torch.equal(spec, ref_spec) and torch.equal(mel, ref_mel)
    assert torch.equal(spectrogram(y, 512, 128, 512), spectrogram_plain(y, 512, 128, 512))

    qw = prepare_w8a8(torch.tensor(rng.standard_normal((6, c, 3)), dtype=torch.float32))
    assert torch.equal(row_absmax(x, 0.1), row_absmax_plain(x, 0.1))
    assert torch.equal(conv1d_w8a8(x, qw, (1, 1), slope=0.1),
                       conv1d_w8a8_plain(x, qw, (1, 1), slope=0.1))

    a = torch.tensor(rng.standard_normal((2, 9, 2 * h)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((2, 1, 2 * h)), dtype=torch.float32)
    assert torch.equal(fused_gate(a, b, h), fused_add_tanh_sigmoid_multiply(a, b, h))

    scores = torch.tensor(rng.standard_normal((2, 12, 5)), dtype=torch.float32)
    xl, yl = torch.tensor([5, 3]), torch.tensor([12, 7])
    assert torch.equal(maximum_path(scores, xl, yl),
                       maximum_path_plain(scores.transpose(1, 2), length_mask(xl, yl, 5, 12)))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", ["48k_base.json", "base.json"])
def test_config_loads_like_jax(name):
    path = os.path.join(ROOT, "configs", name)
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()


def test_cuda_sources_are_package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert set(data["vcvits_tpu_torch"]) == {"csrc/*.cu", "csrc/*.cuh", "csrc/*.cc"}
    for name in _build.KERNEL_SOURCES:
        assert os.path.exists(os.path.join(PKG, "csrc", f"{name}.cu"))
    assert os.path.exists(os.path.join(PKG, "csrc", "host_dsp.cc"))
