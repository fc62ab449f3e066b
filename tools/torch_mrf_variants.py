#!/usr/bin/env python3
"""Compare builds of K1 (vcvits_tpu_torch/csrc/mrf.cu) in one run on one GPU.

    python3 tools/torch_mrf_variants.py NAME=[@SOURCE.cu] [NVCC FLAGS] ...

Each argument is one variant: NAME, then optionally `@path` to a source
other than csrc/mrf.cu (say, the parent commit's, unpacked into a
git-ignored directory) and extra nvcc flags (`-DNAME=1`). The variants are
built in parallel with the port's nvcc flags into build/torch_kernels/var/,
each is loaded in turn in place of the mrf library, and each is run through
`ops/mrf.py:mrf` and held against `mrf_plain` on small shapes and on the
four decoder stages of a 10 s request ([1, 7440, 256] ... [1, 476160, 32],
random weights, fp32 and bf16 weights). Prints ptxas's register and spill
lines per variant, the error (fp32: max |err|, bf16: error RMS, both over
the output's RMS) and the CUDA-event time of each stage, and the totals.
A variant's source must keep the C entry points `mrf_pair` and `mrf_plan`
of the wrapper in ops/mrf.py. Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vcvits_tpu_torch.ops import _build  # noqa: E402
from vcvits_tpu_torch.ops import mrf as K1  # noqa: E402

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
STAGES = ((7440, 256), (59520, 128), (238080, 64), (476160, 32))
SMALL = ((32, 1000, 1, KS, DS), (64, 333, 2, KS, DS), (256, 97, 1, KS, DS),
         (128, 20, 1, KS, DS), (256, 55, 1, KS, DS), (64, 500, 1, (3, 5), ((1, 2), (1,))),
         (96, 300, 2, KS, DS), (160, 77, 1, (3,), ((1, 7),)))


def build(name: str, spec: str):
    src = str(_build.CSRC / "mrf.cu")
    if spec.startswith("@"):
        src, _, spec = spec[1:].partition(" ")
    out = _build.BUILD_DIR / "var" / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *spec.split(), "-o", str(out), src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    notes = [line.strip() for line in (r.stdout + r.stderr).splitlines()
             if "registers" in line or "spill" in line or "rror" in line or "erialized" in line]
    return name, out, r.returncode, notes


def inputs(rng, c, t, b, ks, ds, wdt, dev):
    x = torch.tensor(rng.standard_normal((b, t, c)), dtype=torch.float32, device=dev)
    blocks = [tuple(torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32, device=dev)
                    .to(wdt).contiguous()
                    for s, sc in (((len(d), k, c, c), 1 / np.sqrt(k * c)), ((len(d), c), 0.1),
                                  ((len(d), k, c, c), 1 / np.sqrt(k * c)), ((len(d), c), 0.1)))
              for k, d in zip(ks, ds)]
    return x, blocks


def rel_err(got, ref, wdt) -> float:
    d = got.float() - ref.float()
    e = d.pow(2).mean().sqrt() if wdt == torch.bfloat16 else d.abs().max()
    return e.item() / ref.float().pow(2).mean().sqrt().item()


def use(path) -> None:
    _build._LIBS["mrf"] = ctypes.CDLL(str(path))


def event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mrf_variants: no CUDA device is available", file=sys.stderr)
        return 1
    variants = dict(arg.split("=", 1) for arg in sys.argv[1:]) or {"current": ""}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    (_build.BUILD_DIR / "var").mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda kv: build(*kv), variants.items()))
    libs = {}
    for name, path, rc, notes in built:
        print(f"{name}: nvcc exit {rc}; " + " | ".join(notes))
        if rc == 0:
            libs[name] = path
    dev = torch.device("cuda")
    for name, path in libs.items():
        use(path)
        for c, t, b, ks, ds in SMALL:
            for wdt in (torch.float32, torch.bfloat16):
                x, blocks = inputs(np.random.default_rng(c + t), c, t, b, ks, ds, wdt, dev)
                try:
                    e = rel_err(K1.mrf(x, blocks, ks, ds), K1.mrf_plain(x, blocks, ks, ds), wdt)
                    print(f"{name} small C={c} T={t} B={b} {str(wdt)[6:]}: err {e:.3e}")
                except (RuntimeError, ValueError) as exc:
                    print(f"{name} small C={c} T={t} B={b} {str(wdt)[6:]}: failed: {exc}")
    totals = {}
    rng = np.random.default_rng(0)
    for wdt in (torch.float32, torch.bfloat16):
        for t, c in STAGES:
            x, blocks = inputs(rng, c, t, 1, KS, DS, wdt, dev)
            ref = K1.mrf_plain(x, blocks, KS, DS)
            for name, path in libs.items():
                use(path)
                try:
                    e = rel_err(K1.mrf(x, blocks, KS, DS), ref, wdt)
                    ms = event_ms(lambda: K1.mrf(x, blocks, KS, DS))
                except (RuntimeError, ValueError) as exc:
                    print(f"{name} [1,{t},{c}] {str(wdt)[6:]}: failed: {exc}")
                    continue
                totals.setdefault((name, str(wdt)[6:]), []).append(ms)
                print(f"{name} [1,{t},{c}] {str(wdt)[6:]}: err {e:.3e} ms {ms:.4f}", flush=True)
            del x, blocks, ref
    for (name, label), per in totals.items():
        print(f"total {name} {label}: {sum(per):.4f} ms, per stage "
              f"{', '.join(f'{v:.4f}' for v in per)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
