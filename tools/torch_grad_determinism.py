#!/usr/bin/env python3
"""Where one process's fp32 train step on the GPU differs from itself.

    python3 tools/torch_grad_determinism.py [--config configs/base.json]

Takes one fp32 train step of the config at its batch, learning rate 0, on
chip_smoke.py's seeded weights and batch (`base_model`, `train_batch`),
several times in one process, each from the same state:

- twice as PyTorch runs by default;
- twice with cuDNN's deterministic algorithms alone;
- twice under `torch.use_deterministic_algorithms(True, warn_only=True)`
  (cuDNN deterministic, cuBLAS's workspace fixed, uninitialised memory
  filled with NaN), listing the ops PyTorch flags as nondeterministic;
- once more deterministically with HuBERT's features nudged by 1e-7 of
  their RMS, to show how far the gradients move for a rounding-sized change
  of the input.

For each pair it prints the activations that differ, in the order the step
made them (the frozen features, the content encoder's sublayers, the
posterior, the flow, KL's inputs), then the loss's gradients with respect
to them as the backward pass left them; the ReLUs of the prior's FFNs
whose input changed sign, beside the output channel where that conv's
weight gradient moved most; and per parameter group (gen.enc_p, gen.dec,
..., disc.msd) the gradients' relative L2 error, max |err| over the
group's RMS and over its largest, and where it is worst. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the seeded weights, the batch, the gradients)

NUDGE = 1e-7  # of the features' RMS


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def watched(gen) -> list:
    """The generator's modules whose first output of a step is recorded:
    HuBERT's front end and first layer's parts, then each of its layers,
    the prior's sublayers (with each FFN's first conv, the ReLU's input),
    the posterior, the flow and the decoder."""
    hub = gen.enc_p.hubert
    names = [f"enc_p.hubert.feature_extractor.conv_{i}" for i in range(hub.feature_extractor.n)]
    names += [f"enc_p.hubert.{m}" for m in ("feature_extractor.group_norm", "feature_extractor",
                                            "feat_ln", "post_extract_proj", "pos_conv",
                                            "encoder_ln", "layer_0.attn.q_proj",
                                            "layer_0.attn", "layer_0.ln1", "layer_0.fc1",
                                            "layer_0.fc2", "layer_0.ln2")]
    names += [f"enc_p.hubert.layer_{i}" for i in range(hub.cfg.num_layers)]
    names += ["enc_p.hubert", "enc_p.hubert_proj", "enc_p.emb_pitch"]
    for i in range(gen.enc_p.encoder.n_layers):
        names += [f"enc_p.encoder.{s}" for s in (f"attn_{i}", f"norm1_{i}", f"ffn_{i}.conv_1",
                                                  f"ffn_{i}", f"norm2_{i}")]
    names += ["enc_p.proj", "enc_q", "flow", "dec"]
    return names


def run_step(cfg, sd, batch, dev, nudge: float = 0.0) -> dict:
    """One step from `sd`: the recorded activations in order, the metrics and
    the gradients (on the host)."""
    from vcvits_tpu_torch.train import step as step_mod
    from vcvits_tpu_torch.train.step import TrainStep

    step = TrainStep(cfg, device=dev, g_state=sd)
    acts, grads_of = {}, {}

    def keep_grad(key, g):
        grads_of.setdefault(f"d loss / d {key}", g.detach().float().cpu())

    def keep(name, out):
        for i, t in enumerate(_tensors(out)):
            key = f"{name}[{i}]"
            if key not in acts and t.is_floating_point():
                acts[key] = t.detach().float().cpu()
                if t.requires_grad:
                    t.register_hook(lambda g, key=key: keep_grad(key, g))

    mods = dict(step.gen.named_modules())
    hooks = [mods[n].register_forward_hook(lambda m, a, o, n=n: keep(n, o))
             for n in watched(step.gen)]
    keep("batch", [v for v in batch.values() if v.is_floating_point()])
    features = step._features

    def feats(b):
        x_wav, hub, y_spec, y_mel = features(b)
        if nudge and hub is not None:
            g = torch.Generator(device=hub.device).manual_seed(7)
            hub = hub + nudge * hub.pow(2).mean().sqrt() * torch.randn(
                hub.shape, generator=g, device=hub.device, dtype=hub.dtype)
        keep("features", (x_wav, hub, y_spec, y_mel))
        return x_wav, hub, y_spec, y_mel

    step._features = feats
    kl = step_mod.kl_loss

    def kl_loss(z_p, logs_q, m_p, logs_p, *rest):
        keep("kl inputs (z_p, logs_q, m_p, logs_p)", (z_p, logs_q, m_p, logs_p))
        return kl(z_p, logs_q, m_p, logs_p, *rest)

    step_mod.kl_loss = kl_loss
    try:
        metrics = {k: float(v) for k, v in step(batch).items()}
    finally:
        step_mod.kl_loss = kl
        for h in hooks:
            h.remove()
    grads = chip_smoke._grads(step)
    acts.update(reversed(list(grads_of.items())))  # in the forward's order
    del step
    torch.cuda.empty_cache()
    bad = [k for k, v in grads.items() if not torch.isfinite(v).all()]
    bad += [k for k, v in acts.items() if not torch.isfinite(v).all()]
    return {"acts": acts, "metrics": metrics, "grads": grads, "nonfinite": bad}


def relu_flips(a: dict, b: dict) -> str:
    """Per prior FFN: the ReLU inputs (its first conv's outputs) whose sign
    differs between two runs, with their (row, frame, channel), and the
    output channel where that conv's weight gradient differs most."""
    out = []
    i = 0
    while f"enc_p.encoder.ffn_{i}.conv_1[0]" in a["acts"]:
        x, y = a["acts"][f"enc_p.encoder.ffn_{i}.conv_1[0]"], b["acts"][f"enc_p.encoder.ffn_{i}.conv_1[0]"]
        flips = ((x > 0) != (y > 0)).nonzero().tolist()
        key = f"gen.enc_p.encoder.ffn_{i}.conv_1.weight"
        d = (a["grads"][key] - b["grads"][key]).abs().amax(dim=(1, 2))
        out.append(f"ffn_{i}: {len(flips)} flipped {flips[:6]}, weight gradient worst at output "
                   f"channel {int(d.argmax())} ({float(d.max()):.3e})")
        i += 1
    return "; ".join(out)


def report(label: str, a: dict, b: dict) -> None:
    print(f"== {label}")
    if a["nonfinite"] or b["nonfinite"]:
        print(f"  non-finite: {a['nonfinite'][:8]} / {b['nonfinite'][:8]}")
    shown = 0
    for k, v in a["acts"].items():
        w = b["acts"].get(k)
        if w is None or w.shape != v.shape:
            print(f"  {k}: shapes {tuple(v.shape)} vs {None if w is None else tuple(w.shape)}")
            continue
        err = float((v - w).abs().max())
        if err > 0 and (shown < 6 or not k.startswith("enc_p.hubert.")):
            top = float(v.abs().max())
            print(f"  act {k} {tuple(v.shape)}: max |err| {err:.3e} = {err / max(top, 1e-30):.3e} "
                  f"of its largest ({top:.3e})")
            shown += 1
    if not shown:
        print(f"  all {len(a['acts'])} recorded activations equal")
    print(f"  ReLU flips: {relu_flips(a, b)}")
    worst_m = max(((abs(a["metrics"][k] - v) / max(abs(v), 1e-12), k)
                   for k, v in b["metrics"].items()), default=(0.0, ""))
    print(f"  metrics: worst rel err {worst_m[0]:.3e} ({worst_m[1]})")
    rec = chip_smoke._compare_steps(a["metrics"], a["grads"], b["metrics"], b["grads"])
    print(f"  grads per group (||err|| / ||grad||, max |err| / RMS, max |err| / largest (where)): "
          f"{chip_smoke.groups_line(rec['groups'])}")


def overlap_adds(x_wav: torch.Tensor, d, runs: int = 50) -> str:
    """How many of `runs` overlap-adds of the source's windowed frames
    (smooth_source's iSTFT) differ from the first, by index_add (atomics)
    and by `overlap_add` (F.fold). Each run reads its frames from a new
    place in memory while a GEMM loop keeps a side stream busy, as the
    train step's other work would."""
    from vcvits_tpu_torch.dsp.spectrogram import overlap_add, stft_complex

    re, im = stft_complex(x_wav, d.filter_length, d.hop_length, d.win_length)
    frames = torch.fft.irfft(torch.complex(re, im), n=d.filter_length, dim=-1)
    b, t, n = frames.shape
    idx = (torch.arange(t, device=frames.device)[:, None] * d.hop_length
           + torch.arange(n, device=frames.device)[None, :]).reshape(-1)
    total = n + d.hop_length * (t - 1)
    ways = {"index_add": lambda f: torch.zeros(b, total, device=f.device).index_add(
                1, idx, f.reshape(b, -1)),
            "overlap_add (F.fold)": lambda f: overlap_add(f, d.hop_length)}
    side = torch.cuda.Stream()
    m = torch.randn(4096, 4096, device=frames.device)
    rng = np.random.default_rng(0)
    out = []
    for name, fn in ways.items():
        first, differ, worst = fn(frames), 0, 0.0
        for _ in range(runs - 1):
            shift = torch.empty(int(rng.integers(1, 1 << 20)), device=frames.device)
            moved = frames.clone()
            with torch.cuda.stream(side):
                for _ in range(4):
                    m = m @ m * 1e-2
            e = float((fn(moved) - first).abs().max())
            differ, worst = differ + (e > 0), max(worst, e)
            del shift
        torch.cuda.synchronize()
        out.append(f"{name}: {differ} of {runs - 1} runs differ from the first, by up to "
                   f"{worst:.3e}")
    return "; ".join(out)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=chip_smoke.BASE_CONFIG)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_grad_determinism: no CUDA device is available", file=sys.stderr)
        return 1
    from vcvits_tpu_torch.ops import _build

    print(chip_smoke.info_line())
    _build.build()
    dev = chip_smoke._rank_device(0)
    cfg = chip_smoke.frozen_lr(args.config)
    model, _ = chip_smoke.base_model(cfg, dev)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    batch = chip_smoke.train_batch(cfg, cfg.train.batch_size, 2.0, 4.0,
                                   np.random.default_rng(42), dev)
    print(f"the source's overlap-add on the card, run again: "
          f"{overlap_adds(batch['x_wav'], cfg.data)}")
    default = [run_step(cfg, sd, batch, dev) for _ in range(2)]
    report("default algorithms, run 2 against run 1", default[1], default[0])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cudnn = [run_step(cfg, sd, batch, dev) for _ in range(2)]
    report("cuDNN deterministic alone, run 2 against run 1", cudnn[1], cudnn[0])

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        det = [run_step(cfg, sd, batch, dev) for _ in range(2)]
        nudged = run_step(cfg, sd, batch, dev, nudge=NUDGE)
    flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
    print(f"ops flagged nondeterministic under use_deterministic_algorithms: {len(flagged)}")
    for msg in flagged:
        print(f"  {msg}")
    report("deterministic algorithms, run 2 against run 1", det[1], det[0])
    report("deterministic against default (run 1 each)", det[0], default[0])
    report(f"deterministic, HuBERT features nudged by {NUDGE:g} of their RMS", nudged, det[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
