"""Spawned ranks, and the multi-rank dry run (the port's counterpart of
__graft_entry__.py:dryrun_multichip).

`launch(fn, n, *args)` runs `fn(rank, n, *args)` in n spawned processes
joined in one process group (a file store, so concurrent launches never
share a port) and returns each rank's return value. `dryrun_multigpu(n)`
runs three stages on a tiny config over n ranks:

1. one GAN train step on a data x model grid (model 2 when n is even),
   held to the one-process step on the same global batch and draws;
2. inference with the generator sharded over the model group, held to
   the unsharded generator;
3. one checkpoint written from that layout, restored in a fresh process
   group of another layout, every tensor equal to the saved one.

It runs over NCCL, one card a rank, when n cards are present, and over
gloo otherwise: the ranks share the cards there (NCCL refuses two ranks on
one card), or the CPU without one.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _child(rank: int, fn, n: int, args, store: str, backend: str, out: str,
           timeout: float) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vcvits_tpu_torch.parallel.mesh import distributed_init

    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(rank)
    distributed_init(init_method=f"file://{store}", world_size=n, rank=rank, backend=backend,
                     timeout=timeout)
    try:
        result = fn(rank, n, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, backend: str = "gloo", workdir: Optional[str] = None,
           timeout: float = 300.0) -> List[Any]:
    """`fn(rank, n, *args)` in n spawned processes over one process group
    (`backend`; a collective waits at most `timeout` seconds); returns the
    ranks' return values in rank order. A rank's exception is raised here.
    `fn` must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        mp.spawn(_child, args=(fn, n, args, store, backend, tmp, timeout), nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def reinit(n: int, rank: int, store: str, backend: str, timeout: float = 300.0) -> None:
    """A fresh process group (a new file store) in place of the current one."""
    import torch.distributed as dist

    from vcvits_tpu_torch.parallel.mesh import distributed_init

    if dist.is_initialized():
        dist.destroy_process_group()
    distributed_init(init_method=f"file://{store}", world_size=n, rank=rank, backend=backend,
                     timeout=timeout)


# ---------------------------------------------------------------- dry run

TINY_HUBERT = dict(conv_layers=((32, 10, 5), (32, 8, 8), (32, 8, 8)), hidden_size=32,
                   num_layers=2, num_heads=4, intermediate_size=64, pos_conv_kernel=8,
                   pos_conv_groups=2)


def tiny_config(batch_size: int) -> Dict:
    """JAX's dry-run config, widened where the tensor-parallel rule has a
    width floor: upsample_initial_channel 512 (conv_pre and up_0 sharded),
    hidden 64 (the flow's and the posterior's speaker layers, 512 and 2048
    wide, sharded)."""
    return {
        "train": {"segment_size": 2048, "batch_size": batch_size, "disc_time_fold": False,
                  "steps_per_epoch": 10},
        "data": {"filter_length": 1024, "win_length": 1024, "hop_length": 512,
                 "n_mel_channels": 16, "n_speakers": 16},
        "model": {
            "inter_channels": 16, "hidden_channels": 64, "filter_channels": 64,
            "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1,
            "hubert_channels": 32, "num_pitch": 64, "gin_channels": 8,
            "upsample_initial_channel": 512,
            "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
            "multi_period_discriminator_periods": [2, 3],
        },
    }


def tiny_batch(b: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's dry-run batch shapes: 2560 source samples, 7680 target."""
    g = np.random.default_rng(seed)
    tx, ty = 2560, 7680
    return {"x_wav": (g.standard_normal((b, tx)) * 0.1).astype(np.float32),
            "x_wav_lengths": np.full((b,), tx, np.int32),
            "x_pitch": g.integers(1, 64, (b, tx // 320)).astype(np.int64),
            "y_wav": (g.standard_normal((b, ty)) * 0.1).astype(np.float32),
            "y_wav_lengths": np.full((b,), ty, np.int32),
            "sid": g.integers(0, 16, (b,)).astype(np.int64)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.pow(2).mean().sqrt().clamp_min(1e-30))


def _dryrun_rank(rank: int, n: int, workdir: str, backend: str) -> Dict[str, Any]:
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.data.loader import to_device
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.ops import _build
    from vcvits_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager
    from vcvits_tpu_torch.train.step import TrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one card a rank under NCCL; under gloo ranks share the cards (or the CPU)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    dev = torch.device("cuda", rank % n_cards) if n_cards else torch.device("cpu")
    t0 = time.monotonic()
    model = 2 if n % 2 == 0 else 1
    data = n // model
    cfg = Config.from_dict(tiny_config(2 * data))
    hub = HubertConfig(**TINY_HUBERT)
    batch = tiny_batch(cfg.train.batch_size)
    out: Dict[str, Any] = {"layout": [data, model]}

    # 1) one DP x TP step against the one-process step (rank 0 runs both)
    ref_metrics = None
    if rank == 0:
        ref = TrainStep(cfg, device=dev, hubert_cfg=hub, seed=0)
        ref_metrics = {k: float(v) for k, v in ref(to_device(batch, dev)).items()}
        del ref
    _build.LAUNCHES.clear()  # count the sharded step and inference alone
    mesh = make_mesh(data, model)
    step = TrainStep(cfg, device=dev, hubert_cfg=hub, seed=0, mesh=mesh)
    metrics = {k: float(v) for k, v in step(to_device(shard_batch(batch, mesh), dev)).items()}
    if rank == 0:
        out["step_max_rel_err"] = max(abs(metrics[k] - ref_metrics[k]) / max(abs(ref_metrics[k]),
                                                                           1e-12)
                                      for k in ref_metrics)
    out["loss_g"], out["loss_d"] = metrics["loss/g/total"], metrics["loss/d/total"]
    out["step_s"] = time.monotonic() - t0

    # 2) TP-sharded inference against the whole generator
    whole = step.state_dict()
    local = to_device(shard_batch(batch, mesh), dev)
    step.gen.eval()
    o, _, _ = step.gen.infer(local["x_wav"], local["x_wav_lengths"], local["x_pitch"],
                             local["sid"], noise_scale=0.0)
    out["launches"] = dict(_build.LAUNCHES)
    if rank == 0:
        plain = TrainStep(cfg, device=dev, hubert_cfg=hub, seed=1, g_state=whole["gen"]).gen
        plain.eval()
        o_ref, _, _ = plain.infer(local["x_wav"], local["x_wav_lengths"], local["x_pitch"],
                                  local["sid"], noise_scale=0.0)
        out["infer_max_rel_err"] = _rel(o.float(), o_ref.float())
        out["infer_shape"] = list(o.shape)
    out["infer_finite"] = bool(torch.isfinite(o).all())

    # 3) save from this layout, restore in a fresh group of another one
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"))
    if rank == 0:
        ckpt.save(1, whole)
        ckpt.wait()
    mesh.agree(False)  # the checkpoint is complete before any rank reads it
    reinit(n, rank, os.path.join(workdir, "store2"), backend)
    other = (n, 1) if model > 1 else ((n // 2, 2) if n % 2 == 0 else (n, 1))
    mesh2 = make_mesh(*other)
    step2 = TrainStep(cfg, device=dev, hubert_cfg=hub, seed=7, mesh=mesh2)
    step2.load_state_dict(ckpt.restore(1))
    back = step2.state_dict()
    if rank == 0:
        diffs = [float((back[side][k].cpu() - whole[side][k].cpu()).abs().max())
                 for side in ("gen", "disc") for k in whole[side]]
        out["restore_max_abs_diff"] = max(diffs)
        out["restore_layout"] = list(other)
    out["seconds"] = time.monotonic() - t0
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    mesh2.agree(False)
    return out


def dryrun_multigpu(n: int, workdir: Optional[str] = None) -> Dict[str, Any]:
    """The three stages over n ranks; returns rank 0's record (its errors
    against the one-process step, the unsharded generator and the saved
    checkpoint, and the kernel launches of its sharded step and inference)
    and prints one line a stage. Raises if a stage is off."""
    backend = "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= n else "gloo"
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        rec = launch(_dryrun_rank, n, tmp, backend, backend=backend, workdir=tmp)[0]
    rec["backend"] = backend
    data, model = rec["layout"]
    print(f"dryrun_multigpu({n}): {data}x{model} over {backend}: loss_g={rec['loss_g']:.4f} "
          f"loss_d={rec['loss_d']:.4f}, metrics vs one process max rel "
          f"{rec['step_max_rel_err']:.2e}: train-step OK", flush=True)
    print(f"dryrun_multigpu({n}): TP-sharded inference out={tuple(rec['infer_shape'])} "
          f"max |err| {rec['infer_max_rel_err']:.2e} x RMS vs unsharded OK", flush=True)
    print(f"dryrun_multigpu({n}): checkpoint restored at {rec['restore_layout']}, max |diff| "
          f"{rec['restore_max_abs_diff']:.1e} OK ({rec['seconds']:.1f} s)", flush=True)
    if not (rec["infer_finite"] and rec["step_max_rel_err"] < 1e-4
            and rec["infer_max_rel_err"] < 1e-4 and rec["restore_max_abs_diff"] == 0.0):
        raise AssertionError(f"dryrun_multigpu({n}) is off: {rec}")
    return rec
