#!/usr/bin/env python3
"""Drive the PyTorch port (vcvits_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

1. Prints the card's name and power limit, and the torch/CUDA versions.
2. Builds the CUDA kernels from vcvits_tpu_torch/csrc/ (one nvcc per
   source, all at once) and prints ptxas's register/spill report.
3. Kernel phases at the main path's shapes, each kernel against its plain
   PyTorch version on the card, TF32 off:
   * flow_coupling_reverse (K2): 4 couplings on [1, 930, 128], hidden 128,
     random non-zero weights; float32, max |err| <= 1e-4 x output RMS.
   * mrf (K1): the four decoder stages of a 10 s utterance, [1, 7440, 256]
     ... [1, 476160, 32], random weights; float32 (max |err| <= 1e-4 x
     output RMS) and bf16 weights (error RMS <= 2e-2 x output RMS).
   Each prints its time, the plain version's time and the least time the
   card could take (the larger of bytes / 3.35 TB/s and operations / peak:
   67 TFLOP/s float32 CUDA cores, 989 TFLOP/s bf16 tensor cores).
4. Slice phase: VoiceConverter at the full configs/48k_base.json widths
   with seeded random weights. A 0.48 s input is converted on the card and
   with the plain path on the CPU, same weights and noise, and must agree
   (atol 1e-3). Then the main path: 3 synthetic 10 s WAVs through
   convert_many with distinct speakers, in float32 and then bf16, with the
   launch counters set to 0 just before and read just after; output lengths
   must equal y_mask.sum() * hop, outputs must be finite, and both kernels
   must have launched the expected number of times per request. A per-part
   time breakdown of one 10 s request follows.
5. Prints a `kernels` JSON line, then, last, the result line
   {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero; without a GPU it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
FLOW_TOL = 1e-4
MRF_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_ATOL = 1e-3
STAGE_SHAPES = ((7440, 256), (59520, 128), (238080, 64), (476160, 32))  # 930 frames, 10 s
FLOW_FRAMES, FLOW_CH, FLOW_HID, FLOW_LAYERS, FLOW_K, N_FLOWS = 930, 128, 128, 4, 5, 4
SPEAKERS = (3, 77, 411)


def cuda_ms(fn, reps: int = 3) -> float:
    """Device time of fn() in ms: one warm-up call, then CUDA events around
    `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, _build, name: str, reps: int = 3):
    """(cuda_ms(fn), launches of kernel `name` per call of fn, counted)."""
    n0 = _build.LAUNCHES[name]
    ms = cuda_ms(fn, reps)
    return ms, (_build.LAUNCHES[name] - n0) / (reps + 1)


def rel_err(got: torch.Tensor, ref: torch.Tensor, bf16: bool = False):
    """(max |err|, the error measure relative to the output's RMS): the
    largest error in float32, the error's RMS with bf16 weights (there,
    which bf16 step an input rounds to differs between the two sums, and
    that spreads through the chained convs)."""
    diff = got.float() - ref.float()
    d = diff.abs().max().item()
    rms = ref.float().pow(2).mean().sqrt().item()
    measure = diff.pow(2).mean().sqrt().item() if bf16 else d
    return d, measure / max(rms, 1e-12)


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def info_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_phase(_build) -> None:
    took = _build.build()
    print(f"build: {json.dumps({k: round(v, 1) for k, v in took.items()})} s")
    for name in _build.KERNEL_SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        regs = [int(line.split("Used ")[1].split()[0]) for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                     for line in log.splitlines() if "spill stores" in line)
        print(f"ptxas {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"spill stores {spills} bytes")


def flow_phase(rng, dev, _build):
    from vcvits_tpu_torch.ops.flow_coupling import (
        coupling_reverse, coupling_reverse_plain, pick_tile)

    c, h, n_l, k, t = FLOW_CH, FLOW_HID, FLOW_LAYERS, FLOW_K, FLOW_FRAMES
    half = c // 2
    shapes = ((half, h), (h,), (n_l, k, h, 2 * h), (n_l, 2 * h), (n_l, h, 2 * h), (n_l, 2 * h),
              (h, half), (half,))

    def rand(shape, scale):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)

    couplings = [tuple(rand(s, 1.0 / np.sqrt(s[-2] * (k if len(s) == 4 else 1)) if len(s) > 1
                            else 0.1) for s in shapes) for _ in range(N_FLOWS)]
    for cw in couplings:  # the last WN layer's res_skip has H outputs, packed into the skip half
        cw[4][-1, :, :h] = 0
        cw[5][-1, :h] = 0
    conds = [rand((1, n_l * 2 * h), 0.3) for _ in range(N_FLOWS)]
    x = rand((1, t, c), 1.0)
    mask = torch.ones(1, t, 1, device=dev)

    def chain(fn):
        y = x
        for w, cnd in zip(couplings, conds):
            y = fn(torch.flip(y, dims=[-1]).contiguous(), mask, cnd, w)
        return y

    got, ref = chain(coupling_reverse), chain(coupling_reverse_plain)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    if not (rel <= FLOW_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"flow_coupling_reverse: max |err| {err:.3e} = {rel:.3e} x RMS "
                             f"> {FLOW_TOL}")
    ms, launches = timed(lambda: chain(coupling_reverse), _build, "flow_coupling_reverse")
    plain_ms = cuda_ms(lambda: chain(coupling_reverse_plain))
    # per frame: pre, n_l in-convs, n_l - 1 res_skip of H x 2H and the last of
    # H x H, post; the packed zero half of the last res_skip is not counted
    macs = t * N_FLOWS * (half * h + n_l * k * h * 2 * h + (n_l - 1) * h * 2 * h + h * h
                          + h * half)
    n_weights = sum(w.numel() for cw in couplings for w in cw) - N_FLOWS * (h * h + h)
    nbytes = 4 * (N_FLOWS * (2 * t * c + t) + n_weights + sum(cd.numel() for cd in conds))
    b_ms, b_by = bound_ms(2 * macs, nbytes, FP32_FLOPS)
    print(f"flow_coupling_reverse [1,{t},{c}] x{N_FLOWS} couplings fp32 (tile "
          f"{pick_tile(1, t, torch.cuda.get_device_properties(dev).multi_processor_count)}): "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) launches={launches:g} max_abs_err={err:.3e} "
          f"rel={rel:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err}


def mrf_phase(rng, dev, _build):
    from vcvits_tpu_torch.ops.mrf import mrf, mrf_plain

    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    n_w = 2 * sum(k * len(d) for k, d in zip(ks, ds))  # 126 taps of C x C
    out = {}
    for wdt in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
        for t, c in STAGE_SHAPES:
            xdt = torch.float32 if wdt == torch.float32 else torch.bfloat16
            x = torch.tensor(rng.standard_normal((1, t, c)), dtype=torch.float32,
                             device=dev).to(xdt)
            blocks = []
            for k, dil in zip(ks, ds):
                n = len(dil)
                blocks.append(tuple(
                    torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32, device=dev)
                    .to(wdt).contiguous()
                    for s, sc in (((n, k, c, c), 1 / np.sqrt(k * c)), ((n, c), 0.1),
                                  ((n, k, c, c), 1 / np.sqrt(k * c)), ((n, c), 0.1))))
            got = mrf(x, blocks, ks, ds)
            ref = mrf_plain(x, blocks, ks, ds)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref, bf16=wdt == torch.bfloat16)
            if not (rel <= MRF_TOL[wdt] and torch.isfinite(got.float()).all()):
                raise AssertionError(f"mrf C={c} T={t} {wdt}: max |err| {err:.3e}, "
                                     f"relative error {rel:.3e} > {MRF_TOL[wdt]}")
            ms, launches = timed(lambda: mrf(x, blocks, ks, ds), _build, "mrf")
            plain_ms = cuda_ms(lambda: mrf_plain(x, blocks, ks, ds))
            isz_w, isz_x = (4, 4) if wdt == torch.float32 else (2, 2)
            nbytes = 2 * t * c * isz_x + (n_w * c * c + 2 * 9 * c) * isz_w
            b_ms, b_by = bound_ms(2 * n_w * c * c * t, nbytes,
                                  FP32_FLOPS if wdt == torch.float32 else BF16_FLOPS)
            print(f"mrf [1,{t},{c}] {str(wdt)[6:]}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) launches={launches:g} "
                  f"max_abs_err={err:.3e} rel={rel:.3e}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms)):
                tot[key] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_by"] = b_by
            del x, blocks, got, ref
        print(f"mrf all 4 stages {str(wdt)[6:]}: kernel_ms={tot['ms']:.4f} "
              f"plain_ms={tot['plain_ms']:.4f} bound_ms={tot['bound_ms']:.4f}")
        out[wdt] = tot
    return out


def write_sources(tmp: str, n: int = 3, seconds: float = 10.0, sr: int = 22050):
    """Synthetic voiced sources: a gliding harmonic tone with vibrato and
    breath noise, one per speaker, from a fixed seed."""
    from vcvits_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(11)
    t = np.arange(int(seconds * sr)) / sr
    paths = []
    for i in range(n):
        f0 = 140.0 * (1 + 0.3 * i) * (1 + 0.2 * t / seconds) * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(0.3 / (h + 1) * np.sin((h + 1) * phase) for h in range(6))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t) ** 2) + 0.01 * rng.standard_normal(len(t))
        p = os.path.join(tmp, f"src{i}.wav")
        write_wav(p, wav.astype(np.float32), sr, subtype="PCM_16")
        paths.append(p)
    return paths


def reference_check(cfg, dev) -> None:
    """A short input through the card (kernels) and the CPU (plain path),
    same weights and noise. The seeded weights are perturbed first: JAX's
    initialisers leave the flow's `post` at zero (the flow an identity) and
    the decoder's N(0, 0.01) convs give a near-silent output, which would
    make the comparison check little."""
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    model = SynthesizerSVC.from_config(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("flow.") and ".post." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.startswith("dec.") and name.endswith(".g"):
                p.mul_(3.0)  # output mean |y| about 0.3, unsaturated
    sd = model.state_dict()
    del model
    rng = np.random.default_rng(5)
    n = 7680
    t = np.arange(n) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)
    pitch = np.full(n // 320, 120, np.int64)
    eps = rng.standard_normal((1, 45, cfg.model.inter_channels)).astype(np.float32)
    outs = []
    for device in (dev, "cpu"):
        vc = VoiceConverter(cfg, sd, device=device)
        outs.append(vc.convert_array(wav, pitch, 7, noise_scale=0.8, eps=eps))
        del vc
    gpu, cpu = outs
    diff = float(np.abs(gpu - cpu).max())
    level = float(np.abs(cpu).mean())
    print(f"slice reference (0.48 s, card kernels vs CPU plain path, fp32): samples={len(gpu)} "
          f"max_abs_err={diff:.3e} mean|y|={level:.3e}")
    if len(gpu) != len(cpu) or not diff <= SLICE_ATOL or not level > 1e-2:
        raise AssertionError(f"slice: card and CPU outputs differ by {diff:.3e} (limit "
                             f"{SLICE_ATOL}) at mean |y| {level:.3e}")


def breakdown(vc, wav, pitch, label) -> None:
    """Device time of each part of one 10 s request (CUDA events)."""
    from vcvits_tpu_torch.ops.mrf import mrf
    from vcvits_tpu_torch.models.layers import leaky_relu
    from vcvits_tpu_torch.utils.masking import nearest_interp, sequence_mask

    g_mod, dev = vc.gen, vc.device
    x = torch.as_tensor(wav, device=dev)[None]
    lens = torch.tensor([len(wav)], device=dev)
    pit = torch.as_tensor(pitch, device=dev)[None]
    sid = torch.tensor([3], device=dev)
    parts = {}
    with torch.no_grad():
        enc = g_mod.enc_p(x, lens, pit)
        parts["hubert+prior"] = cuda_ms(lambda: g_mod.enc_p(x, lens, pit), 2)
        g = g_mod.emb_g(sid)
        t_out = int(round(x.shape[1] * 3 / 512))
        y_mask = sequence_mask((lens.float() * (3 / 512)).int(), t_out).to(enc[1].dtype)
        z_p = nearest_interp(enc[1], t_out)
        parts["flow (K2)"] = cuda_ms(lambda: g_mod.flow.kernel_reverse(z_p, y_mask, g), 2)
        dec = g_mod.dec
        h = dec.conv_pre(z_p) + dec.cond(g)[:, None, :]
        for i, blocks in enumerate(dec.mrf_weights()):
            up = getattr(dec, f"up_{i}")
            parts[f"up_{i}"] = cuda_ms(lambda: up(leaky_relu(h)), 2)
            h = up(leaky_relu(h)).contiguous()
            parts[f"mrf_{i} (K1)"] = cuda_ms(lambda: mrf(h, blocks, dec.kernel_sizes,
                                                          dec.dilations), 2)
            h = mrf(h, blocks, dec.kernel_sizes, dec.dilations)
        parts["conv_post"] = cuda_ms(lambda: dec.conv_post(leaky_relu(h, 0.01)), 2)
    total = sum(parts.values())
    print(f"breakdown {label} (device ms, one 10 s request): " + ", ".join(
        f"{k}={v:.3f}" for k, v in parts.items()) + f"; sum={total:.3f}")


def slice_phase(dev, _build, card: str):
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.dsp.resample import resample
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.utils.audio_io import read_wav

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "48k_base.json"))
    reference_check(cfg, dev)
    m = cfg.model
    per_req = {"mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes),
               "flow_coupling_reverse": 4}
    hop = cfg.data.hop_length
    ls = (cfg.data.target_sampling_rate / hop) / cfg.data.source_sampling_rate
    with tempfile.TemporaryDirectory() as tmp:
        srcs = write_sources(tmp)
        true_lens = [len(resample(*read_wav(p), cfg.data.source_sampling_rate)) for p in srcs]
        jobs = [(s, os.path.join(tmp, f"out{i}.wav"), sid)
                for i, (s, sid) in enumerate(zip(srcs, SPEAKERS))]
        vcs = {}
        _build.LAUNCHES.clear()
        runs = 0
        for dtype in (torch.float32, torch.bfloat16):
            vc = VoiceConverter(cfg, dtype=dtype, device=dev, seed=0)
            vcs[dtype] = vc
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            outs = vc.convert_many(jobs, collect_audio=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs += len(jobs)
            for (_, dst, _), out, true_len in zip(jobs, outs, true_lens):
                y_len = int((torch.tensor([true_len], dtype=torch.float32) * ls)
                            .to(torch.int32).item())
                written, sr = read_wav(dst)
                if len(out) != y_len * hop or len(written) != len(out) or sr != 48000:
                    raise AssertionError(f"{dst}: {len(out)} samples, expected {y_len * hop}")
                if not np.isfinite(out).all():
                    raise AssertionError(f"{dst}: non-finite output")
            for name, n in per_req.items():
                rose = _build.LAUNCHES[name] - before.get(name, 0)
                if rose != n * len(jobs):
                    raise AssertionError(f"{name}: {rose} launches for {len(jobs)} requests, "
                                         f"expected {n * len(jobs)}")
            secs = sum(len(o) for o in outs) / 48000
            label = str(dtype)[6:]
            print(f"slice {label}: convert_many 3 x 10 s, {wall * 1e3 / len(jobs):.1f} ms per "
                  f"request incl. host prep, rtf={secs / wall:.2f}x real time on {card}; "
                  f"launches { {k: _build.LAUNCHES[k] - before.get(k, 0) for k in per_req} }")
        counts = dict(_build.LAUNCHES)
        # device-side numbers after the counted run: one prepared request
        wav, true_len, pitch = vcs[torch.float32].prepare_source(srcs[0])
        for dtype, vc in vcs.items():
            label = str(dtype)[6:]
            def one():
                vc.convert_array(wav, pitch, 3, true_len)
            one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                one()
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / 3
            print(f"slice {label}: convert_array (prepared 10 s source) {per * 1e3:.1f} ms per "
                  f"request, rtf={true_len / 16000 / per:.2f}x real time on {card}")
            breakdown(vc, wav, pitch, label)
    for name, n in per_req.items():
        if counts.get(name, 0) != n * runs:
            raise AssertionError(f"{name}: launched {counts.get(name, 0)} times on the main "
                                 f"path, expected {n * runs}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from vcvits_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = info_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_phase(_build)
    rng = np.random.default_rng(0)
    flow = flow_phase(rng, dev, _build)
    mrf_res = mrf_phase(rng, dev, _build)
    counts = slice_phase(dev, _build, card)
    print(f"kernels: {json.dumps(['mrf', 'flow_coupling_reverse'])}; all phases "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    f32, b16 = mrf_res[torch.float32], mrf_res[torch.bfloat16]
    kernels = [
        {"name": "mrf", "route": "cuda", "source": "vcvits_tpu_torch/csrc/mrf.cu",
         "replaces": "vcvits_tpu/ops/mrf_pallas.py:134", "launches": counts.get("mrf", 0),
         "max_abs_err": f32["max_abs_err"], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
         "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": None,
         "ms_bf16": b16["ms"], "plain_ms_bf16": b16["plain_ms"],
         "bound_ms_bf16": b16["bound_ms"], "max_abs_err_bf16": b16["max_abs_err"]},
        {"name": "flow_coupling_reverse", "route": "cuda",
         "source": "vcvits_tpu_torch/csrc/flow_coupling.cu",
         "replaces": "vcvits_tpu/ops/flow_pallas.py:137",
         "launches": counts.get("flow_coupling_reverse", 0),
         "max_abs_err": flow["max_abs_err"], "ms": flow["ms"], "plain_ms": flow["plain_ms"],
         "bound_ms": flow["bound_ms"], "bound_by": flow["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
