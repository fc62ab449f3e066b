#!/usr/bin/env python3
"""Time and profile the port's GAN train step at full widths on one GPU.

    python3 tools/torch_train_profile.py [DTYPE:BATCH:BENCHMARK[:K] ...]

Each case (default: float32:16:0 bfloat16:16:0 bfloat16:16:1 bfloat16:8:0
bfloat16:8:1, K 1) builds a `TrainStep` on configs/48k_base.json with the
seeded, perturbed weights and the synthetic 2-4 s batch of chip_smoke.py
(`perturbed_state`, `train_batch`), in DTYPE (float32 or bfloat16) at
BATCH, with `torch.backends.cudnn.benchmark` off (0) or on (1: cuDNN times
its algorithms for each new shape and keeps the fastest), and K mini-steps
an update (`accumulate_grad_batches`). It runs one warm-up step and 4
timed steps (host clock around each, synchronised),
then one step under torch.profiler: device-busy time, idle share, the
costliest kernels and the kernel classes of chip_smoke.py's
`device_profile`, and the peak memory. TF32 stays off. Exits non-zero
without a GPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ("float32:16:0", "bfloat16:16:0", "bfloat16:16:1", "bfloat16:8:0", "bfloat16:8:1")
TIMED_STEPS = 4


def run_case(spec: str, card: str) -> None:
    import chip_smoke as cs
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.train.step import TrainStep

    import dataclasses

    name, batch_size, bench, *k = spec.split(":")
    dtype = getattr(torch, name)
    torch.backends.cudnn.benchmark = bench == "1"
    cfg = load_config(cs.CONFIG)
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, accumulate_grad_batches=int(k[0]) if k else 1))
    batch = cs.train_batch(cfg, int(batch_size), 2.0, 4.0, np.random.default_rng(8), "cuda")
    step = TrainStep(cfg, device="cuda", g_state=cs.perturbed_state(cfg), dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    walls = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{spec}: {np.mean(walls) * 1e3:.1f} ms/step (steps {', '.join(f'{w * 1e3:.1f}' for w in walls)}; "
          f"first {first * 1e3:.1f}), peak {peak:.2f} GiB on {card}")
    cs.device_profile(lambda: step(batch), spec, card)
    del step, batch
    torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.info_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for spec in argv or DEFAULT:
        run_case(spec, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
