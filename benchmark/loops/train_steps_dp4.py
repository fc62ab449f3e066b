"""The conversion model's GAN train step, data-parallel: `TrainStep.__call__`
on a `Mesh` of `world` data ranks, one process a card, the gradients
summed over NCCL after each backward.

Traffic parameters: those of benchmark/loops/train_steps.py, "batch_size"
being the rows a card, and "world" (the ranks) and "rank_timeout_s" (how
long the ranks' rendezvous may take).

Rank 0 is the benchmark's own process, on cuda:0: the harness's calls run
there and only it is traced. `setup` starts ranks 1 .. world - 1 as
processes of this module (`python -m benchmark.loops.train_steps_dp4`,
the cell's context in their arguments), rank r on cuda:r, and all join
one process group at a localhost port that rank 0 picked (NCCL on the
cards, gloo on the CPU). A gloo group beside it carries rank 0's commands:
a word before each step of a window, and the end of the run (`free`),
after which every rank leaves the process group and its process ends.
Rank 0 waits for them.

Every rank draws the same weights, and makes the same global batches
(world x batch_size rows) and the same global draws from the seed on its
card, and keeps its rows of each batch: each step is the one-process step
on the global batch (train/step.py's module docstring). Set-up runs the
first `check_steps` steps on every rank; rank 0 keeps what the check
compares (the global losses, the first gradient after the sum, the
parameters before and after), as train_steps.py does, and the first
global batches and draws, for the reference.

The check is train_steps.py's: benchmark/reference/train.py's fp32 step on
the global batches and draws, on card 0 alone once the ranks are gone,
against the cell's limits.

A run never hangs on a rank: rank 0 watches its workers, and one that
ends before `free`, or ends with a non-zero code, ends rank 0's process at
once with code 1; a worker ends when rank 0's process is gone; and the
rendezvous waits at most rank_timeout_s. A fault planted on rank 0 whose
name is in benchmark/faults_cells.py's `ACTIVE` is planted on every rank.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

import torch

from benchmark import harness, synth, weights
from benchmark.loops import common, train_steps
from benchmark.reference import train as ref_train

STEP, FREE = 1, 2
CONTROL_TIMEOUT_S = 3600
FREE_TIMEOUT_S = 60


class State:
    pass


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(ctx: harness.Context, rank: int) -> torch.device:
    return torch.device("cuda", rank) if ctx.device.type == "cuda" else torch.device("cpu")


def _context_args(ctx: harness.Context) -> str:
    return json.dumps({"root": ctx.root, "workload": ctx.workload,
                       "config_entry": ctx.config_entry, "config": ctx.config,
                       "traffic": ctx.traffic, "seed": ctx.seed, "seconds": ctx.seconds,
                       "limits": ctx.limits, "device": ctx.device.type})


def _context_of(text: str, rank: int) -> harness.Context:
    d = json.loads(text)
    ctx = harness.Context(d["root"], d["workload"], d["config_entry"], d["config"], d["traffic"],
                          d["seed"], d["seconds"], False, limits=d["limits"])
    ctx.device = torch.device("cuda", rank) if d["device"] == "cuda" else torch.device("cpu")
    return ctx


def _join(ctx: harness.Context, rank: int, world: int, port: int):
    """This rank in the process group, its command group and the mesh."""
    import torch.distributed as dist

    from vcvits_tpu_torch.parallel.mesh import distributed_init, make_mesh

    on_card = ctx.device.type == "cuda"
    distributed_init(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                     backend="nccl" if on_card else "gloo",
                     timeout=float(ctx.traffic.get("rank_timeout_s", 60)))
    control = dist.new_group(backend="gloo", timeout=timedelta(seconds=CONTROL_TIMEOUT_S))
    return control, make_mesh()


def _build(ctx: harness.Context, rank: int, world: int, port: int) -> State:
    """The program on this rank, its rows of the global batches, the global
    draws, and the first `check_steps` steps taken."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.train.step import StepDraws, TrainStep

    st = State()
    st.control, mesh = _join(ctx, rank, world, port)
    tr, cfg_json = ctx.traffic, ctx.config["config"]
    model, data, hub = common.model_blocks(ctx)
    seeds = train_steps._seeds(ctx.seed)
    dev = _device(ctx, rank)
    st.cfg_json, st.hub, st.seeds, st.dtype = cfg_json, hub, seeds, train_steps._dtype(ctx)
    cfg = Config.from_dict(cfg_json)
    gw = weights.draw(model, data, hub, ctx.seed, dev)
    dw = weights.draw_specs(ref_train.disc_specs(model), seeds["disc"], dev)
    st.step = TrainStep(cfg, device=dev, hubert_cfg=common.port_hubert_cfg(ctx),
                        seed=seeds["step"], g_state=gw, d_state=dw, dtype=st.dtype, mesh=mesh)
    del gw, dw
    gen = torch.Generator(device=dev).manual_seed(seeds["data"])
    bucket = int(round(tr["bucket_s"] * synth.SR))
    b = int(tr["batch_size"])
    rows = b * world
    k = int(tr["check_steps"])
    st.batches, st.ref_batches, shapes = [], [], []
    for i in range(int(tr["batches"])):
        whole = synth.make_train_batch(rows, bucket, tr["min_s"], tr["max_s"], gen, dev,
                                       data["n_speakers"], model["num_pitch"],
                                       data["target_sampling_rate"])
        st.batches.append({n: v[rank * b:(rank + 1) * b].clone() for n, v in whole.items()})
        shapes.append({"y_wav": torch.empty(whole["y_wav"].shape, device="meta"),
                       "y_wav_lengths": whole["y_wav_lengths"]})
        if rank == 0 and i < k:
            st.ref_batches.append(whole)
        del whole
    # the global batches' draws, every rank alike (each program keeps its rows)
    st.draws = train_steps.make_draws(len(shapes), rows, cfg_json, shapes, gen, dev)
    named = train_steps._named(st.step)
    st.p0 = {n: p.detach().cpu().clone() for n, p in named.items()}
    st.losses = []
    beta1 = cfg_json["train"]["betas"][0]
    for i in range(k):
        m = st.step(st.batches[i], StepDraws(**st.draws[i]))
        st.losses.append((float(m["loss/g/total"]), float(m["loss/d/total"])))
        if i == 0:
            st.grad1 = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).cpu()
                        for opt in (st.step.g_opt, st.step.d_opt)
                        for n, p in named.items() if p in opt.state}
    st.p3 = {n: p.detach().cpu().clone() for n, p in named.items()}
    st.next = k
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def _say(st: State, word: int) -> int:
    """Rank 0's command `word` to every rank (on the others: the command
    received)."""
    import torch.distributed as dist

    t = torch.tensor([word], dtype=torch.int64)
    dist.broadcast(t, 0, group=st.control)
    return int(t.item())


# ------------------------------------------------------------------ rank 0
def _watch(st: State) -> None:
    """Rank 0's watch over its workers: one that ends before `free`, or
    ends badly, ends this process with code 1."""
    while not st.done:
        for r, p in enumerate(st.procs, start=1):
            code = p.poll()
            if code is not None and (code != 0 or not st.freeing):
                print(f"benchmark: rank {r} ended with code {code}; ending the run",
                      file=sys.stderr, flush=True)
                _kill(st.procs)
                os._exit(1)
        time.sleep(0.2)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def setup(ctx: harness.Context) -> State:
    from benchmark import faults_cells

    world = int(ctx.traffic["world"])
    port = _free_port()
    args = _context_args(ctx)
    planted = ",".join(sorted(faults_cells.ACTIVE))
    procs = []
    for r in range(1, world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "benchmark.loops.train_steps_dp4", "--rank", str(r),
             "--world", str(world), "--port", str(port), "--faults", planted, "--ctx", args],
            cwd=ctx.root, env=dict(os.environ, PYTHONPATH=ctx.root)))
    atexit.register(_kill, procs)
    holder = State()
    holder.procs, holder.freeing, holder.done = procs, False, False
    threading.Thread(target=_watch, args=(holder,), daemon=True).start()
    st = _build(ctx, 0, world, port)
    st.procs, st.watch = procs, holder
    return st


def modules(st: State) -> dict:
    return {"gen": st.step.gen, "disc": st.step.disc}


def window(st: State, ctx: harness.Context) -> harness.WindowResult:
    from vcvits_tpu_torch.train.step import StepDraws

    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    n = len(st.batches)
    steps = 0
    t0 = time.perf_counter()
    close = t0 + ctx.seconds
    while time.perf_counter() < close:
        i = (st.next + steps) % n
        _say(st, STEP)
        st.step(st.batches[i], StepDraws(**st.draws[i]))
        if on_card:
            torch.cuda.synchronize()
        steps += 1
    wall = time.perf_counter() - t0
    st.next += steps
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    return harness.WindowResult(attempted=steps, failed=0, window_s=wall, completed=steps,
                                data={"errors": [], "peak": peak, "state": st})


def end_to_end(st: State, res: harness.WindowResult) -> dict:
    return train_steps.end_to_end(st, res)


def record(st: State, res: harness.WindowResult) -> dict:
    """train_steps.py's record: rank 0's operations, on its own rows."""
    return train_steps.record(st, res)


def free(st: State) -> None:
    """Every rank leaves together: the command, then each rank (this one
    too) closes the process group, which NCCL does with every rank at
    once; the workers' ends are awaited, code 0 each. A rank that does not
    end in FREE_TIMEOUT_S fails the run."""
    st.watch.freeing = True
    _say(st, FREE)
    del st.step
    _leave()
    deadline = time.monotonic() + FREE_TIMEOUT_S
    try:
        for p in st.procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        st.watch.done = True
        _kill(st.procs)
    bad = [p.returncode for p in st.procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"a rank ended with {bad}")


def _leave() -> None:
    """destroy_process_group, bounded: where it has not returned in
    FREE_TIMEOUT_S the run fails rather than hangs."""
    import torch.distributed as dist

    done = threading.Event()

    def leave():
        dist.destroy_process_group()
        done.set()

    threading.Thread(target=leave, daemon=True).start()
    if not done.wait(FREE_TIMEOUT_S):
        raise RuntimeError(f"destroy_process_group did not return in {FREE_TIMEOUT_S} s")


def numbers(res: harness.WindowResult, ctx: harness.Context, control: bool = False):
    """train_steps.py's three numbers of rank 0's first steps (the global
    batch's) against the fp32 reference on the global batches."""
    st = res.data["state"]
    truth = _reference(st, ctx)
    side = _reference(st, ctx, "fp8") if control else \
        {"losses": st.losses, "grad1": st.grad1, "p3": st.p3}
    r = train_steps.compare(side, truth, st.p0)
    nums = {name: r[name] for name in train_steps.NUMBERS}
    notes = {k: r[k] for k in train_steps.REPORTED + ("losses", "ref_losses")}
    notes["left_out"] = r["left_out"]
    return nums, notes


def _reference(st: State, ctx: harness.Context, precision=None) -> dict:
    model, data, hub = common.model_blocks(ctx)
    k = int(ctx.traffic["check_steps"])
    gw = weights.draw(model, data, hub, ctx.seed, ctx.device)
    dw = weights.draw_specs(ref_train.disc_specs(model), st.seeds["disc"], ctx.device)
    draws = [{n: v.to(ctx.device) for n, v in d.items()} for d in st.draws[:k]]
    out = ref_train.train_steps(gw, dw, st.cfg_json, hub, st.ref_batches, draws,
                                st.seeds["step"], precision=precision)
    after = {**{"gen." + n: v for n, v in gw.items() if ref_train.trainable(n)},
             **{"disc." + n: v for n, v in dw.items()}}
    side = {"losses": [(float(g), float(d)) for g, d in zip(out["g_total"], out["d_total"])],
            "grad1": {n: v.cpu() for n, v in out["grads"].items()},
            "p3": {n: v.cpu() for n, v in after.items()}}
    del gw, dw, out, after
    return side


# ----------------------------------------------------------------- workers
def _worker(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--ctx", required=True)
    args = p.parse_args(argv)
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(0.5)

    threading.Thread(target=orphaned, daemon=True).start()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from contextlib import ExitStack

    from benchmark import faults_cells
    from vcvits_tpu_torch.train.step import StepDraws

    ctx = _context_of(args.ctx, args.rank)
    with ExitStack() as planted:
        for name in filter(None, args.faults.split(",")):
            planted.enter_context(faults_cells.FAULTS[name]())
        st = _build(ctx, args.rank, args.world, args.port)
        n = len(st.batches)
        while True:
            word = _say(st, 0)
            if word == STEP:
                st.step(st.batches[st.next % n], StepDraws(**st.draws[st.next % n]))
                st.next += 1
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
            elif word == FREE:
                break
    del st.step
    _leave()
    return 0


if __name__ == "__main__":
    sys.exit(_worker())
