"""tools/torch_convergence_run.py on the CPU, without training: the corpus
at one speaker and one clip, its synthesis functions the same code as the
JAX tool's (tools/convergence_run.py, compared as syntax trees: importing
that tool turns on JAX's persistent compile cache), and the report
assembled from a fake trajectory with the JAX run's keys
(reports/convergence_r5.json).
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest

from vcvits_tpu_torch.utils.audio_io import read_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "torch_convergence_run", os.path.join(ROOT, "tools", "torch_convergence_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _functions(path):
    tree = ast.parse(open(path).read())
    return {n.name: ast.dump(n) for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_synthesis_is_the_jax_tools(tool):
    jax_fns = _functions(os.path.join(ROOT, "tools", "convergence_run.py"))
    port_fns = _functions(os.path.join(ROOT, "tools", "torch_convergence_run.py"))
    for name in ("_formants", "_syllable"):
        assert port_fns[name] == jax_fns[name], name


def test_make_corpus_one_speaker_one_clip(tool, tmp_path):
    fl, vfl = tool.make_corpus(str(tmp_path / "c"), 1, 1)
    assert open(fl).read() == "\n"  # clip 0 of each speaker is held out
    (line,) = open(vfl).read().split()
    path, sid = line.split("|")
    assert sid == "0" and path == str(tmp_path / "c" / "s0_0.wav")
    wav, sr = read_wav(path)
    assert sr == 48000 and 2.5 <= len(wav) / sr <= 5.9
    assert np.isfinite(wav).all() and 0.05 < np.abs(wav).max() <= 1.0
    os.remove(path)
    tool.make_corpus(str(tmp_path / "c"), 1, 1)  # the same seed, the same clip
    np.testing.assert_array_equal(read_wav(path)[0], wav)


def test_report_from_a_fake_trajectory(tool, tmp_path):
    args = tool.parse_args(["--steps", "40", "--batch", "4", "--speakers", "4",
                            "--grown-steps", "3", "--out", str(tmp_path / "r.json")])

    def point(step, mel):
        return {"step": step, "mel": mel, "kl": 2.0, "fm": 1.0, "g_adv": 3.0,
                "g_total": mel + 6.0, "d_total": 2.5, "steps_per_sec": 1.5,
                "host_rss_mb": 1000.0 + step}

    traj = [point(s, 50.0 - s / 2) for s in range(4, 44, 4)]  # 10 points
    val = [{"step": s, "val/mcd_db": 60.0 - s, "val/voicing_f1": 0.5,
            "host_rss_mb": 1.0} for s in (10, 20, 30, 40)]
    report = tool.build_report(args, 12, traj, val, 24, [point(4, 30.0)], True, 12.34,
                               {"name": "card", "name_power_limit": "card, 700.00 W"}, 1.0)
    with open(os.path.join(ROOT, "reports", "convergence_r5.json")) as f:
        jax_keys = set(json.load(f))
    assert set(report) == jax_keys | {"card", "preprocess_s"}
    assert report["mel_early_mean"] == traj[2]["mel"]  # the point at 25 % (k = 1)
    assert report["mel_late_mean"] == traj[-1]["mel"] and report["mel_min"] == traj[-1]["mel"]
    assert report["resume"] == {"phase1_end": 20, "phase2_first_logged": 24}
    assert report["grown_speakers"]["n_speakers"] == 20 and report["grown_speakers"]["finite"]
    assert report["val_first_quarter"] == {"val/mcd_db": 50.0, "val/voicing_f1": 0.5}
    assert report["val_last_quarter"] == {"val/mcd_db": 20.0, "val/voicing_f1": 0.5}
    assert report["all_finite"] and report["host_rss_last_mb"] == 1040.0
    bad = tool.build_report(args, 12, traj + [point(44, float("nan"))], val, 24, [], False,
                            1.0, {}, 0.0)
    assert not bad["all_finite"]
    json.dumps(report)
