#!/usr/bin/env python
"""Long-horizon convergence run of the PyTorch port on a synthetic corpus.

The port's counterpart of tools/convergence_run.py, with the same corpus
and phases: the full GAN system (`vcvits_tpu_torch.train.trainer.Trainer`)
at the default 48 kHz configuration in bf16 with the D-step recompute, on
a multi-speaker formant-synth corpus (per-speaker formant sets and F0
ranges, phrase F0 declination, vibrato and jitter, syllabic envelopes,
unvoiced bursts, silences, per-clip noise floors), its first clip per
speaker held out for validation (MCD, F0 RMSE and voicing F1 every
`--eval-interval` steps, logged into the trajectory).

1. The first half of `--steps`.
2. A fresh Trainer resumes from the latest checkpoint and runs to `--steps`.
3. The shape-tolerant restore on a speaker table grown to `--speakers` + 16
   (fresh optimizer and step count), then `--grown-steps` steps.

It writes a JSON report with the JAX tool's keys (trajectory,
val_trajectory, resume, grown_speakers, mel early / late / min, the
validation quarters, host RSS, all_finite, wall_s), plus the card's name
and power limit and the host preprocessing's seconds; a ".partial" file
beside it holds the trajectory while the run goes on. Runs on the card:

  python tools/torch_convergence_run.py --steps 1000 --out reports/convergence_torch.json

The corpus, caches and checkpoints go under `--root` (a new temporary
directory by default, removed at the end). No TensorBoard events are
copied: the card's machine has no tensorboard package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SR = 48000


def _rss_mb() -> float:
    """Current process resident set size in MB (Linux /proc, no psutil)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return round(pages * os.sysconf("SC_PAGE_SIZE") / 1e6, 1)
    except (OSError, ValueError, IndexError):
        return float("nan")


def _formants(rng, sid):
    """Per-speaker vowel space: 3 formant center sets + bandwidths."""
    base = np.array([500.0, 1500.0, 2500.0])
    spread = rng.uniform(0.85, 1.25, 3)
    vowels = []
    for _ in range(4):  # 4 "vowels" per speaker
        centers = base * spread * rng.uniform(0.75, 1.35, 3)
        bws = rng.uniform(60.0, 140.0, 3)
        gains = rng.uniform(0.6, 1.0, 3)
        vowels.append((centers, bws, gains))
    return vowels


def _syllable(rng, f0, dur, vowel, voiced=True):
    """One syllable: harmonic stack shaped by the formant envelope, or a
    fricative-like noise burst; raised-cosine amplitude envelope."""
    n = max(int(SR * dur), 1)
    t = np.arange(n) / SR
    env = 0.5 - 0.5 * np.cos(2 * np.pi * np.minimum(t / dur, 1.0))
    if not voiced:
        x = rng.standard_normal(n)
        # high-pass-ish fricative color via first difference
        x = np.diff(x, prepend=0.0)
        return (0.12 * env * x).astype(np.float32)
    centers, bws, gains = vowel
    # vibrato + micro-jitter on the contour
    f0_t = f0 * (1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
                 + 0.003 * rng.standard_normal(n).cumsum() / np.sqrt(n))
    phase = 2 * np.pi * np.cumsum(f0_t) / SR
    x = np.zeros(n)
    n_harm = int(min(6000.0, SR / 2 * 0.9) / max(f0, 1.0))
    for h in range(1, max(n_harm, 2)):
        fh = h * f0
        # formant envelope sampled at the harmonic frequency
        amp = 0.08  # glottal rolloff floor
        for c, bw, g in zip(centers, bws, gains):
            amp += g / (1.0 + ((fh - c) / bw) ** 2)
        amp /= h ** 0.5  # source rolloff
        x += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    x /= max(np.max(np.abs(x)), 1e-6)
    # breathiness
    x += 0.015 * rng.standard_normal(n)
    return (0.35 * env * x).astype(np.float32)


def make_corpus(root: str, n_speakers: int, clips_per_speaker: int, seed: int = 1234):
    """Write the corpus's WAVs (48 kHz) and its train and validation
    filelists (clip 0 of each speaker held out) -> (train, validation)."""
    from vcvits_tpu_torch.utils.audio_io import write_wav

    os.makedirs(root, exist_ok=True)
    lines = []
    for sid in range(n_speakers):
        srng = np.random.default_rng(seed + 1000 + sid)
        f0_base = 85.0 * 2 ** (srng.uniform(0.0, 1.6))  # 85..260 Hz
        vowels = _formants(srng, sid)
        for ci in range(clips_per_speaker):
            p = os.path.join(root, f"s{sid}_{ci}.wav")
            lines.append(f"{p}|{sid}")
            if os.path.exists(p):
                continue
            crng = np.random.default_rng(seed + sid * 10007 + ci)
            total = crng.uniform(2.5, 5.5)
            pieces = []
            tpos = 0.0
            f0_phrase = f0_base * crng.uniform(0.9, 1.15)
            while tpos < total:
                dur = crng.uniform(0.08, 0.35)
                kind = crng.random()
                if kind < 0.12:  # silence
                    pieces.append(np.zeros(int(SR * dur), np.float32))
                elif kind < 0.3:  # unvoiced burst
                    pieces.append(_syllable(crng, 0.0, dur * 0.6, None, voiced=False))
                else:  # voiced syllable with declining phrase F0
                    decl = 1.0 - 0.25 * (tpos / total)
                    f0 = f0_phrase * decl * crng.uniform(0.92, 1.2)
                    vowel = vowels[crng.integers(len(vowels))]
                    pieces.append(_syllable(crng, f0, dur, vowel))
                tpos += dur
            y = np.concatenate(pieces)
            # per-clip noise floor: clean through ~20 dB SNR babble-ish hiss
            snr_db = crng.uniform(18.0, 60.0)
            noise = crng.standard_normal(len(y)).astype(np.float32)
            rms_y = float(np.sqrt(np.mean(y ** 2)) + 1e-9)
            noise *= rms_y / 10 ** (snr_db / 20.0)
            write_wav(p, np.clip(y + noise, -1.0, 1.0), SR)
    val_lines = [ln for ln in lines if ln.split("|")[0].endswith("_0.wav")]
    train_lines = [ln for ln in lines if ln not in set(val_lines)]
    fl = os.path.join(root, "train.txt")
    with open(fl, "w") as f:
        f.write("\n".join(train_lines) + "\n")
    vfl = os.path.join(root, "val.txt")
    with open(vfl, "w") as f:
        f.write("\n".join(val_lines) + "\n")
    return fl, vfl


def build_cfg(fl: str, root: str, n_speakers: int, batch: int, ckpt_interval: int,
              vfl: str = "", eval_interval: int = 10 ** 9, log_interval: int = 100):
    from vcvits_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train, batch_size=batch, log_interval=log_interval,
            eval_interval=eval_interval, checkpoint_interval=ckpt_interval,
            max_epochs=10 ** 6),
        data=dataclasses.replace(
            cfg.data, training_files=fl, validation_files=vfl,
            n_speakers=max(n_speakers, 8),
            cache_dir=os.path.join(root, "cache")),
    )


class Run:
    """The trajectory of every finished phase, and the path of the
    in-flight dump (`partial`, or None)."""

    def __init__(self, partial: Optional[str]):
        self.partial = partial
        self.log: List[Dict] = []
        self.val: List[Dict] = []

    def dump(self, log: List[Dict], val_log: List[Dict]) -> None:
        """Write the trajectory so far, so a preempted run still leaves
        evidence (the report is assembled only at the end)."""
        if self.partial is None:
            return
        try:
            with open(self.partial, "w") as f:
                json.dump({"partial": True, "trajectory": self.log + log,
                           "val_trajectory": self.val + val_log}, f)
        except OSError:
            pass

    def phase(self, cfg, fl: str, workdir: str, max_steps: int):
        """One fresh bf16 Trainer fit to `max_steps` -> (log, val_log)."""
        import torch

        from vcvits_tpu_torch.train.trainer import Trainer

        log, val_log = [], []
        trainer = Trainer(cfg, workdir=workdir, dtype=torch.bfloat16)
        orig = trainer.tb.summarize

        def spy(step, scalars=None, **kw):
            if scalars and "val/mcd_db" in scalars:
                val_log.append({"step": step, "host_rss_mb": _rss_mb(),
                                **{k: float(v) for k, v in scalars.items()}})
            if scalars and "loss/g/mel" in scalars:
                log.append({
                    "step": step,
                    "mel": float(scalars["loss/g/mel"]),
                    "kl": float(scalars.get("loss/g/kl", np.nan)),
                    "fm": float(scalars.get("loss/g/p_fm", np.nan))
                    + float(scalars.get("loss/g/s_fm", np.nan)),
                    "g_adv": float(scalars.get("loss/g/p_gen", np.nan))
                    + float(scalars.get("loss/g/s_gen", np.nan)),
                    "g_total": float(scalars["loss/g/total"]),
                    "d_total": float(scalars["loss/d/total"]),
                    "steps_per_sec": float(scalars.get("steps_per_sec", np.nan)),
                    "host_rss_mb": _rss_mb(),
                })
                self.dump(log, val_log)
            return orig(step, scalars=scalars, **kw)

        trainer.tb.summarize = spy
        trainer.fit(train_files=fl, max_steps=max_steps)
        del trainer
        torch.cuda.empty_cache()
        self.log.extend(log)
        self.val.extend(val_log)
        return log, val_log


def card_info() -> Dict[str, str]:
    """The card's name from torch and its name and power limit from
    nvidia-smi."""
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not measured"
    return {"name": torch.cuda.get_device_name(0), "name_power_limit": smi}


def build_report(args, n_clips: int, traj: List[Dict], val_traj: List[Dict],
                 resume_start: Optional[int], log3: List[Dict], grown_ok: bool,
                 wall_s: float, card: Dict[str, str], preprocess_s: float) -> Dict:
    """The report: JAX's keys (tools/convergence_run.py), the card and the
    preprocessing's seconds. Plateau statistics: the last 10% of the mel
    trajectory against the 25-35% window."""
    mels = [p["mel"] for p in traj]
    d_tot = [p["d_total"] for p in traj]
    k = max(len(mels) // 10, 1)
    early = mels[len(mels) // 4: len(mels) // 4 + k]
    late = mels[-k:]
    metrics = ("val/mcd_db", "val/f0_rmse_cents", "val/voicing_f1")
    q = max(len(val_traj) // 4, 1)

    def quarter(points):
        return {m: float(np.mean([p[m] for p in points if m in p]))
                for m in metrics if any(m in p for p in points)}

    return {
        "steps": args.steps,
        "batch": args.batch,
        "corpus": {"clips": n_clips, "speakers": args.speakers, "sr": SR,
                   "style": "formant-synth multi-speaker"},
        "bf16": True,
        "d_recompute_forward": True,
        "trajectory": traj,
        "val_trajectory": val_traj,
        "resume": {"phase1_end": args.steps // 2, "phase2_first_logged": resume_start},
        "grown_speakers": {"n_speakers": args.speakers + 16, "steps": args.grown_steps,
                           "finite": grown_ok, "points": log3[:5]},
        "mel_early_mean": float(np.mean(early)) if early else None,
        "mel_late_mean": float(np.mean(late)) if late else None,
        "mel_min": float(np.min(mels)) if mels else None,
        "val_first_quarter": quarter(val_traj[:q]),
        "val_last_quarter": quarter(val_traj[-q:]),
        "host_rss_first_mb": traj[0]["host_rss_mb"] if traj else None,
        "host_rss_last_mb": traj[-1]["host_rss_mb"] if traj else None,
        "d_total_late_mean": float(np.mean(d_tot[-k:])) if d_tot else None,
        "all_finite": bool(np.isfinite(mels).all() and np.isfinite(d_tot).all()),
        "wall_s": round(wall_s, 1),
        "card": card,
        "preprocess_s": round(preprocess_s, 1),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--speakers", type=int, default=32)
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--eval-interval", type=int, default=500)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--grown-steps", type=int, default=300,
                    help="steps of phase 3, on the grown speaker table")
    ap.add_argument("--root", default=None,
                    help="corpus, caches and checkpoints (default: a new temporary "
                         "directory, removed at the end)")
    ap.add_argument("--out", default="reports/convergence_torch.json")
    ap.add_argument("--phase3-only", action="store_true",
                    help="skip the training phases and run only the grown-speaker "
                         "tolerant restore against the checkpoints already in <root>/logs")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the three phases; write and return the report."""
    import torch

    from vcvits_tpu_torch.data.dataset import VoiceConversionDataset, preprocess
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_convergence_run: no CUDA device is available")
    t0 = time.time()
    own_root = args.root is None
    root = tempfile.mkdtemp(prefix="convergence_") if own_root else args.root
    run = Run(args.out + ".partial")
    try:
        fl, vfl = make_corpus(os.path.join(root, "corpus"), args.speakers, args.clips)
        n_clips = sum(1 for _ in open(fl))
        print(f"corpus: {n_clips} train clips (+{args.speakers} val), {args.speakers} speakers",
              flush=True)
        workdir = os.path.join(root, "logs")
        cfg = build_cfg(fl, root, args.speakers, args.batch, 2000, vfl=vfl,
                        eval_interval=args.eval_interval, log_interval=args.log_interval)
        t_prep = time.time()
        for f in (fl, vfl):
            ds = VoiceConversionDataset(f, cfg.data)
            # spawned workers pay a torch import each: a few clips go inline
            preprocess(ds, num_workers=min(8, len(ds) // 8), log_every=0)
        preprocess_s = time.time() - t_prep

        half = args.steps // 2
        log1 = log2 = vlog1 = vlog2 = []
        resume_start = None
        if not args.phase3_only:
            log1, vlog1 = run.phase(cfg, fl, workdir, half)
            print(f"phase 1 done at ~{half} steps ({len(log1)} log points)", flush=True)
            log2, vlog2 = run.phase(cfg, fl, workdir, args.steps)
            resume_start = log2[0]["step"] if log2 else None
            print(f"phase 2 resumed (first logged step {resume_start}) -> {args.steps}",
                  flush=True)

        # Phase 3: the grown table must exceed the run's own n_speakers, or no
        # shape differs and the normal restore keeps the step count. The
        # tolerant restore reads the latest checkpoint only, so only it is
        # copied; it resets the optimizer and the step count.
        n_grown = args.speakers + 16
        cfg_grown = build_cfg(fl, root, args.speakers, args.batch, ckpt_interval=10 ** 9,
                              log_interval=args.log_interval)
        cfg_grown = dataclasses.replace(
            cfg_grown, data=dataclasses.replace(cfg_grown.data, n_speakers=n_grown))
        grow_dir = os.path.join(root, "logs_grown")
        shutil.rmtree(grow_dir, ignore_errors=True)
        ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
        latest = ckpt.latest_step()
        shutil.copytree(ckpt.step_dir(latest), os.path.join(grow_dir, "checkpoints", str(latest)))
        log3, _ = run.phase(cfg_grown, fl, grow_dir, args.grown_steps)
        grown_ok = bool(log3) and all(np.isfinite(p["g_total"]) for p in log3)
        print(f"grown-speaker tolerant restore ({args.speakers} -> {n_grown}): {len(log3)} "
              f"points, finite={grown_ok}", flush=True)

        report = build_report(args, n_clips, log1 + log2, vlog1 + vlog2, resume_start, log3,
                              grown_ok, time.time() - t0, card_info(), preprocess_s)
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    if os.path.exists(run.partial):
        os.remove(run.partial)
    span = ("no training phases (--phase3-only)" if report["mel_early_mean"] is None else
            f"mel {report['mel_early_mean']:.2f} -> {report['mel_late_mean']:.2f}")
    print(f"wrote {args.out}; {span}", flush=True)
    return report


if __name__ == "__main__":
    main()
