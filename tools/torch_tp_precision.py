#!/usr/bin/env python3
"""A multi-rank train step's gradients against world 1's on one GPU, with
and without a collective left out.

    python3 tools/torch_tp_precision.py [--config configs/base.json]

Two ranks share the card over gloo (as chip_smoke.py's multi_gpu phase
runs them), under deterministic algorithms (chip_smoke.py's
`_rank_device`), and take one fp32 train step of the config at its batch,
learning rate 0, on seeded weights drawn on the card (chip_smoke.py's
`base_model`); rank 0 first takes the same step twice at world 1. The
layouts: TP = 2; TP = 2 with copy_to's backward missing its all_reduce;
DP = 2; DP = 2 with the gradients not summed over the data group
(tests/torch_parallel_ranks.py:planted). For each it prints the metrics'
worst relative error and per parameter group (gen.enc_p, gen.dec, ...,
disc.msd) the gradients' ||err|| / ||grad|| beside chip_smoke.py's limit
(`grad_limit`), max |err| over the group's RMS and over its largest: the
faultless layouts should sit below the limits and the planted faults far
above.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the phase's helpers: weights, batch, comparison)

LAYOUTS = (("TP=2", 1, 2, None), ("TP=2, copy_to without its all_reduce", 1, 2, "copy_to"),
           ("DP=2", 2, 1, None), ("DP=2, gradients not summed", 2, 1, "sum_grads"))


def _planted():
    """tests/torch_parallel_ranks.py's `planted`, loaded by path (an
    installed package may own the name `tests`)."""
    path = os.path.join(ROOT, "tests", "torch_parallel_ranks.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_ranks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.planted


def layouts_rank(rank: int, n: int, config: str) -> dict:
    from vcvits_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vcvits_tpu_torch.train.step import TrainStep

    planted = _planted()
    dev = chip_smoke._rank_device(rank)
    cfg = chip_smoke.frozen_lr(config)
    model, _ = chip_smoke.base_model(cfg, dev)
    sd = model.state_dict()
    batch = chip_smoke.train_batch(cfg, cfg.train.batch_size, 2.0, 4.0,
                                   np.random.default_rng(42), dev)
    out = {}
    if rank == 0:
        runs = []
        for _ in range(2):
            ref = TrainStep(cfg, device=dev, g_state=sd)
            runs.append(({k: float(v) for k, v in ref(batch).items()}, chip_smoke._grads(ref)))
            del ref
        out["world 1 run twice"] = chip_smoke._compare_steps(*runs[1], *runs[0])
    del model
    torch.cuda.empty_cache()
    for label, data, model_n, fault in LAYOUTS:
        mesh = make_mesh(data, model_n)
        with planted(fault) if fault else contextlib.nullcontext():
            step = TrainStep(cfg, device=dev, g_state=sd, mesh=mesh)
            m = {k: float(v) for k, v in step(shard_batch(batch, mesh)).items()}
            g = chip_smoke._grads(step)
        if rank == 0:
            out[label] = chip_smoke._compare_steps(m, g, *runs[0])
        del step, g
        torch.cuda.empty_cache()
        mesh.agree(False)
    return out if rank == 0 else None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=chip_smoke.BASE_CONFIG)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_tp_precision: no CUDA device is available", file=sys.stderr)
        return 1
    from vcvits_tpu_torch.ops import _build
    from vcvits_tpu_torch.parallel.dryrun import launch

    print(chip_smoke.info_line())
    _build.build()  # once, before the ranks load the libraries
    rec = launch(layouts_rank, 2, args.config, backend="gloo", timeout=1800)[0]
    print(f"{os.path.basename(args.config)}, deterministic algorithms; per group ||err|| / "
          f"||grad|| (limit), max |err| / RMS, max |err| / largest (where)")
    for label, r in rec.items():
        print(f"{label}: metrics {r['metric_rel']:.2e} ({r['metric']}); off the limit: "
              f"{chip_smoke.off_groups(r)}; {chip_smoke.groups_line(r['groups'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
