"""VITS (github.com/jaywalnut310/vits, configs/vctk_base.json) on the port's
TTS training path, on the CPU.

The published config loads through `load_config`; with the keys that
select VITS's architecture (the multi-period discriminator alone, no pitch
or energy heads, 178 symbols) a seeded `TTSTrainStep` at a small width is
benchmark/reference/tts.py's plain float32 step: the loss terms, every
leaf's first gradient, the parameters after two steps, and the alignment
bit for bit. The reference's MAS is the program's plain path; the defaults
build today's vcvits trees; the TTS model's spans open where they are
documented, and the gradient sum's only on a data group of several
ranks.
"""

import json
import os

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import faults_cells, synth_tts, weights
from benchmark.loops import train_steps
from benchmark.reference import train as ref_train
from benchmark.reference import tts as ref_tts
from vcvits_tpu_torch.config import Config, load_config
from vcvits_tpu_torch.models import synthesizer_tts
from vcvits_tpu_torch.models.discriminators import Discriminators
from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS
from vcvits_tpu_torch.ops.monotonic_align import maximum_path as program_path
from vcvits_tpu_torch.parallel.dryrun import launch
from vcvits_tpu_torch.text.symbols import symbols
from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = os.path.join(ROOT, "configs", "vctk_base.json")
BENCH_CFG = os.path.join(ROOT, "benchmark", "configs", "vits_vctk.json")
HOP = 256


def tiny_vits() -> dict:
    """The benchmark's VITS configuration (published + the added keys),
    narrowed: hidden 32, one text-encoder layer, decoder from 64 channels,
    two periods, 4 speakers, 40 symbols, a 2048-sample segment."""
    with open(BENCH_CFG) as f:
        cfg = json.load(f)["config"]
    cfg["model"].update(hidden_channels=32, inter_channels=16, filter_channels=64, n_layers=1,
                        upsample_initial_channel=64, gin_channels=16, n_vocab=40,
                        multi_period_discriminator_periods=[2, 3])
    cfg["data"].update(n_speakers=4)
    cfg["train"].update(segment_size=2048)
    return cfg


def batches_and_draws(cfg, n, seed=3, rows=2):
    gen = torch.Generator().manual_seed(seed)
    batches = [synth_tts.make_tts_batch(rows, 20, 30, 30, 5, 9, cfg["model"]["n_vocab"],
                                        cfg["data"]["n_speakers"], HOP, 22050, gen, "cpu")
               for _ in range(n)]
    draws = []
    seg = cfg["train"]["segment_size"] // HOP
    for b in batches:
        rows_, t_x = b["text"].shape
        t_y = b["y_wav"].shape[1] // HOP
        u = torch.rand(rows_, generator=gen)
        top = torch.clamp_min(b["y_wav_lengths"] // HOP - seg + 1, 1)
        draws.append({"eps": torch.randn(rows_, t_y, cfg["model"]["inter_channels"], generator=gen),
                      "e_q": torch.randn(rows_, t_x, 2, generator=gen),
                      "ids_str": torch.floor(u * top.float()).int()})
    return batches, draws


# ------------------------------------------------------------------ config
def test_published_config_loads():
    cfg = load_config(PUBLISHED)
    assert cfg.data.target_sampling_rate == cfg.data.sampling_rate == 22050
    assert cfg.train.epochs == 10000 and cfg.train.batch_size == 64
    assert cfg.data.add_blank and cfg.data.cleaned_text
    assert cfg.data.text_cleaners == ("english_cleaners2",)
    assert (cfg.data.filter_length, cfg.data.hop_length, cfg.data.n_mel_channels) == \
        (1024, 256, 80)
    assert Config.from_dict(cfg.to_dict()) == cfg
    # the added keys VITS's JSON does not state keep vcvits's defaults
    assert cfg.model.msd_scales == 5 and cfg.model.variance_predictors
    assert cfg.model.n_vocab is None


@pytest.mark.parametrize("name", ["48k_base.json", "base.json"])
def test_vcvits_configs_keep_their_dict(name):
    d = load_config(os.path.join(ROOT, "configs", name)).to_dict()
    for key in ("msd_scales", "variance_predictors", "n_vocab"):
        assert key not in d["model"]
    for key in ("sampling_rate", "add_blank", "text_cleaners", "cleaned_text"):
        assert key not in d["data"]
    assert "epochs" not in d["train"]


def test_sampling_rate_must_agree_with_the_target_rate():
    with pytest.raises(ValueError, match="sampling_rate"):
        Config.from_dict({"data": {"sampling_rate": 22050, "target_sampling_rate": 48000}})


def test_benchmark_config_is_the_published_one_plus_its_added_keys():
    with open(BENCH_CFG) as f:
        bench = json.load(f)
    with open(PUBLISHED) as f:
        published = json.load(f)
    added = {k.split(".", 1)[1] for k in bench["added"]}
    cfg = bench["config"]
    assert {k: v for k, v in cfg["model"].items() if k not in added} == published["model"]
    assert cfg["train"] == published["train"] and cfg["data"] == published["data"]
    c = Config.from_dict(cfg)
    assert c.model.msd_scales == 0 and not c.model.variance_predictors
    assert c.model.n_vocab == 178 and c.model.multi_period_discriminator_periods == (2, 3, 5, 7, 11)


# --------------------------------------------------------- default trees
def test_default_discriminators_are_todays():
    cfg = load_config(os.path.join(ROOT, "configs", "48k_base.json"))
    disc = Discriminators.from_config(cfg)
    model = cfg.to_dict()["model"]
    want = {n: s for n, s, _ in ref_train.disc_specs(model)}
    assert {n: tuple(p.shape) for n, p in disc.named_parameters()} == want
    assert disc.msd is not None and disc.msd.n_scales == 5
    vits = Discriminators.from_config(Config.from_dict(tiny_vits()))
    assert vits.msd is None
    assert {n for n, _ in vits.named_parameters()} == \
        {n for n, _, _ in ref_tts.disc_specs(tiny_vits()["model"])}


def test_default_tts_model_is_todays():
    cfg = tiny_vits()
    cfg["model"].update(variance_predictors=True, n_vocab=None)
    today = SynthesizerTTS.from_config(Config.from_dict(cfg), device="cpu", seed=0)
    cfg["model"].update(variance_predictors=False, n_vocab=40)
    vits = SynthesizerTTS.from_config(Config.from_dict(cfg), device="cpu", seed=0)
    names = {n for n, _ in today.named_parameters()}
    extra = names - {n for n, _ in vits.named_parameters()}
    assert extra and all(n.startswith(("pitch_predictor.", "energy_predictor.")) for n in extra)
    assert today.enc_p.emb.weight.shape[0] == len(symbols)
    assert vits.enc_p.emb.weight.shape[0] == 40


# ----------------------------------------------------------- the reference
def test_dataset_without_the_pitch_head_runs_no_pitch_estimate(tmp_path, monkeypatch):
    """VITS has no pitch predictor: its dataset runs no pYIN and its batch
    has no "pitch"; the default dataset keeps both."""
    import numpy as np

    from vcvits_tpu_torch.data import tts_dataset
    from vcvits_tpu_torch.utils.audio_io import write_wav

    t = np.arange(11025) / 22050
    path = str(tmp_path / "a.wav")
    write_wav(path, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), 22050)
    fl = tmp_path / "train.txt"
    fl.write_text(f"{path}|3|Hello there.\n")
    data = load_config(PUBLISHED).data

    def refused(*a, **k):
        raise AssertionError("pitch estimated")

    monkeypatch.setattr(tts_dataset, "estimate_pitch", refused)
    ds = tts_dataset.TTSDataset(str(fl), data, cache_dir=str(tmp_path / "c"), pitch=False)
    item = ds.get_item(0)
    assert "pitch" not in item
    batch = tts_dataset.collate_tts([item], data, 16, 8192)
    assert set(batch) == {"text", "text_lengths", "y_wav", "y_wav_lengths", "sid"}
    monkeypatch.undo()
    ds = tts_dataset.TTSDataset(str(fl), data, cache_dir=str(tmp_path / "d"))
    batch = tts_dataset.collate_tts([ds.get_item(0)], data, 16, 8192)
    assert batch["pitch"].shape == (1, 8192 // HOP)


def test_plain_mas_is_the_programs_cpu_path():
    g = torch.Generator().manual_seed(7)
    b, t_y, t_x = 5, 41, 13
    # integer scores: many ties, where the path must stay on its position
    score = torch.randint(-3, 3, (b, t_y, t_x), generator=g).float()
    xl = torch.tensor([13, 9, 1, 13, 4])
    yl = torch.tensor([41, 30, 17, 13, 4])
    assert torch.equal(ref_tts.maximum_path(score, xl, yl), program_path(score, xl, yl))
    score = torch.randn(b, t_y, t_x, generator=g) * 10
    assert torch.equal(ref_tts.maximum_path(score, xl, yl), program_path(score, xl, yl))


def test_vits_step_is_the_reference():
    """Two seeded fp32 steps with dropout on, program against reference."""
    cfg = tiny_vits()
    c = Config.from_dict(cfg)
    gspecs, dspecs = ref_tts.param_specs(cfg["model"], cfg["data"]), ref_tts.disc_specs(cfg["model"])
    gw, dw = weights.draw_specs(gspecs, 11, "cpu"), weights.draw_specs(dspecs, 12, "cpu")
    p0 = {**{"gen." + k: v.clone() for k, v in gw.items()},
          **{"disc." + k: v.clone() for k, v in dw.items()}}
    step = TTSTrainStep(c, device="cpu", seed=5, g_state={k: v.clone() for k, v in gw.items()},
                        d_state={k: v.clone() for k, v in dw.items()})
    batches, draws = batches_and_draws(cfg, 2)
    paths = []
    real = synthesizer_tts.maximum_path

    def spy(*a):
        paths.append(real(*a))
        return paths[-1]

    named = {**{"gen." + k: p for k, p in step.gen.named_parameters()},
             **{"disc." + k: p for k, p in step.disc.named_parameters()}}
    synthesizer_tts.maximum_path = spy
    try:
        metrics, grad1 = [], {}
        for i, (b, d) in enumerate(zip(batches, draws)):
            metrics.append(step(b, TTSStepDraws(**d)))
            if i == 0:
                grad1 = {n: p.grad.clone() for n, p in named.items()}
    finally:
        synthesizer_tts.maximum_path = real
    out = ref_tts.train_steps(gw, dw, cfg, batches, draws, 5)
    for m, g_total, d_total, terms in zip(metrics, out["g_total"], out["d_total"],
                                          out["g_terms"]):
        assert float(m["loss/g/total"]) == pytest.approx(float(g_total), rel=1e-5)
        assert float(m["loss/d/total"]) == pytest.approx(float(d_total), rel=1e-5)
        for k, v in terms.items():
            assert float(m["loss/g/" + k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    assert set(grad1) == set(out["grads"])
    for n, want in out["grads"].items():
        tol = 1e-4 * float(want.abs().max()) + 1e-7
        assert torch.allclose(grad1[n], want, rtol=1e-4, atol=tol), n
    assert all(torch.equal(a, b) for a, b in zip(paths, out["paths"]))
    # the parameters after both steps by the benchmark's measure (AdamW moves
    # an element whose gradient is rounding noise by the sign of that noise)
    after = {**{"gen." + k: v for k, v in gw.items()}, **{"disc." + k: v for k, v in dw.items()}}
    r = train_steps.compare({"losses": [(0.0, 0.0)], "grad1": grad1,
                             "p3": {n: p.detach() for n, p in named.items()}},
                            {"losses": [(1.0, 1.0)], "grad1": out["grads"], "p3": after}, p0)
    assert r["grad_gap_median"] < 1e-6 and r["change_gap_median"] < 1e-5, r
    assert r["change_gap_worst"] < 0.02, r


def test_uniform_alignment_fault_changes_the_path():
    xl, yl = torch.tensor([3, 5]), torch.tensor([7, 5])
    path = faults_cells.uniform_path(xl, yl, 5, 8)
    assert path[0].sum(0)[:7].tolist() == [1.0] * 7 and path[0, :, 7].sum() == 0
    assert path[0].sum(1).tolist() == [3.0, 2.0, 2.0, 0.0, 0.0]
    assert torch.equal(path[1, :, :5], torch.eye(5))


# ------------------------------------------------------------------ spans
def _span_names(prof):
    return [e.name()[len("vcvits."):] for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.name().startswith("vcvits.")]


def test_tts_spans_open_in_the_forward_and_in_infer():
    cfg = tiny_vits()
    step = TTSTrainStep(Config.from_dict(cfg), device="cpu", seed=1)
    batches, draws = batches_and_draws(cfg, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batches[0], TTSStepDraws(**draws[0]))
    names = _span_names(prof)
    for s in ("tts.text_encoder", "tts.mas", "tts.sdp"):
        assert names.count(s) == 1, (s, names)
    assert "train.grad_sum" not in names
    g_fwd = names.index("train.g_forward")
    assert g_fwd < names.index("tts.text_encoder") < names.index("tts.mas") \
        < names.index("tts.sdp") < names.index("train.g_losses")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step.gen.infer(batches[0]["text"], batches[0]["text_lengths"], batches[0]["sid"],
                       max_frames=40)
    assert _span_names(prof).count("tts.sdp") == 1


def test_grad_sum_span_opens_only_on_a_data_group(tmp_path):
    names, grad = launch(ranks.grad_sum_spans, 2, workdir=str(tmp_path))[0]
    assert names == ["vcvits.train.grad_sum"] and grad == [3.0, 3.0, 3.0]
    names, grad = ranks.grad_sum_spans(0, 1)
    assert names == [] and grad == [1.0, 1.0, 1.0]
