"""The program's GAN train step, `TrainStep.__call__`, step after step.

Traffic parameters (benchmark/traffic/<mix>.json): "batch_size" (rows a
step), "bucket_s" (the length bucket every batch is padded to), "min_s",
"max_s" (clip lengths drawn within the bucket), "batches" (distinct
batches, cycled), "check_steps" (the steps the reference follows) and
"dtype" ("config": the configuration's train_dtype).

Set-up draws the weights (benchmark/weights.py: the generator's and the
discriminators'), builds one `TrainStep` in the configured compute dtype,
makes the batches on the card from the seed (benchmark/synth.py), and the
draws each step is given (the posterior's noise and segment starts of both
forwards, as `StepDraws`), then drives that step object through its first
`check_steps` steps on distinct batches, through the window's own call:
they build every kernel and warm every shape (one bucket, one shape). It
keeps what the check compares: each step's G and D totals, the first
gradient as AdamW holds it after one step (its first moment over 1 -
beta1), and the trained parameters before and after those steps. The
window then runs the same object on, each step ending in a synchronise;
train_step_ms is the window's wall time over the steps it completed.

The check frees the program, draws the weights again and runs
benchmark/reference/train.py's fp32 step on the same batches and draws,
and compares three numbers, each against its limit
(benchmark/limits/<cell>.json): the median leaf's gap between the two
first-gradient norms; and the median and the worst leaf's gap between the
two norms of the change over the steps, each leaf's gap over the larger of
the reference leaf's norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out (under
AdamW they move by round-off alone). The losses and the worst leaf's
gradient gap are reported beside them, not compared: no control or fault
reads them far enough above sound runs (PERF.md gives the readings).
AdamW's first update has the same size whatever the gradient's, so an
element whose gradient one precision rounds across zero moves 2 x lr the
other way; in the smallest leaves a few such elements, and on some seeds
the third step, move the worst leaf's change by up to 15 % on a sound run.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, synth, weights
from benchmark.loops import common
from benchmark.reference import train as ref_train

SALT = 0x57E9


class State:
    pass


def _seeds(seed: int) -> dict:
    ss = np.random.default_rng([seed, SALT]).integers(0, 2 ** 31 - 1, 3).tolist()
    return {"disc": ss[0], "data": ss[1], "step": ss[2]}


def make_draws(n: int, b: int, cfg: dict, batches: List[dict], gen: torch.Generator,
               device) -> List[dict]:
    """Per step the posterior's noise [B, T_spec, inter] and segment starts
    [B] of both forwards, as the program's generator would draw them."""
    d, t = cfg["data"], cfg["train"]
    hop, seg = d["hop_length"], t["segment_size"] // d["hop_length"]
    out = []
    for i in range(n):
        batch = batches[i % len(batches)]
        t_spec = batch["y_wav"].shape[1] // hop
        lengths = batch["y_wav_lengths"] // hop
        draw = {}
        for suffix in ("", "2"):
            draw["eps" + suffix] = torch.randn((b, t_spec, cfg["model"]["inter_channels"]),
                                               generator=gen, device=device)
            u = torch.rand(b, generator=gen, device=device)
            top = torch.clamp_min(lengths.to(torch.int32) - seg + 1, 1)
            draw["ids_str" + suffix] = torch.floor(u * top.to(u.dtype)).to(torch.int32)
        out.append(draw)
    return out


def _dtype(ctx: harness.Context) -> torch.dtype:
    name = ctx.traffic.get("dtype", "config")
    name = ctx.config["train_dtype"] if name == "config" else name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _named(step) -> Dict[str, torch.nn.Parameter]:
    """The trained parameters by "gen." / "disc." name."""
    g = {"gen." + k: p for k, p in step.gen.named_parameters() if ref_train.trainable(k)}
    return {**g, **{"disc." + k: p for k, p in step.disc.named_parameters()}}


def setup(ctx: harness.Context) -> State:
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.train.step import StepDraws, TrainStep

    tr, cfg_json = ctx.traffic, ctx.config["config"]
    model, data, hub = common.model_blocks(ctx)
    seeds = _seeds(ctx.seed)
    st = State()
    st.cfg_json, st.hub, st.seeds, st.dtype = cfg_json, hub, seeds, _dtype(ctx)
    cfg = Config.from_dict(cfg_json)
    gw = weights.draw(model, data, hub, ctx.seed, ctx.device)
    dw = weights.draw_specs(ref_train.disc_specs(model), seeds["disc"], ctx.device)
    st.step = TrainStep(cfg, device=ctx.device, hubert_cfg=common.port_hubert_cfg(ctx),
                        seed=seeds["step"], g_state=gw, d_state=dw, dtype=st.dtype)
    del gw, dw
    gen = torch.Generator(device=ctx.device).manual_seed(seeds["data"])
    bucket = int(round(tr["bucket_s"] * synth.SR))
    b = int(tr["batch_size"])
    st.batches = [synth.make_train_batch(b, bucket, tr["min_s"], tr["max_s"], gen, ctx.device,
                                         data["n_speakers"], model["num_pitch"],
                                         data["target_sampling_rate"])
                  for _ in range(int(tr["batches"]))]
    st.draws = make_draws(len(st.batches), b, cfg_json, st.batches, gen, ctx.device)
    named = _named(st.step)
    st.p0 = {k: p.detach().cpu().clone() for k, p in named.items()}
    st.losses = []
    k = int(tr["check_steps"])
    for i in range(k):
        m = st.step(st.batches[i], StepDraws(**st.draws[i]))
        st.losses.append((float(m["loss/g/total"]), float(m["loss/d/total"])))
        if i == 0:
            beta1 = cfg_json["train"]["betas"][0]
            st.grad1 = {}
            for opt in (st.step.g_opt, st.step.d_opt):
                for name, p in named.items():
                    if p in opt.state:
                        st.grad1[name] = (opt.state[p]["exp_avg"] / (1 - beta1)).cpu()
    st.p3 = {k: p.detach().cpu().clone() for k, p in named.items()}
    st.next = k
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return st


def modules(st: State) -> dict:
    return {"gen": st.step.gen, "disc": st.step.disc}


def window(st: State, ctx: harness.Context) -> harness.WindowResult:
    from vcvits_tpu_torch.train.step import StepDraws

    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    n = len(st.batches)
    steps, failed, errors = 0, 0, []
    t0 = time.perf_counter()
    close = t0 + ctx.seconds
    while time.perf_counter() < close:
        i = (st.next + steps + failed) % n
        try:
            st.step(st.batches[i], StepDraws(**st.draws[i]))
            if on_card:
                torch.cuda.synchronize()
            steps += 1
        except Exception as e:  # noqa: BLE001 - a failed step, counted
            failed += 1
            errors.append(repr(e))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    return harness.WindowResult(attempted=steps + failed, failed=failed, window_s=wall,
                                completed=steps,
                                data={"errors": errors, "peak": peak, "state": st})


def end_to_end(st: State, res: harness.WindowResult) -> dict:
    return {"train_step_ms": res.window_s * 1e3 / max(res.completed, 1)}


def record(st: State, res: harness.WindowResult) -> dict:
    from benchmark import flops

    b = st.batches[0]
    per_step = flops.train_step_flops(st.cfg_json, st.hub, tuple(b["x_wav"].shape),
                                      tuple(b["y_wav"].shape))
    return {"completed": res.completed, "steps": res.completed,
            "flops": per_step * res.completed,
            "dtype": "bfloat16" if st.dtype == torch.bfloat16 else "float32",
            "peak_bytes": res.data["peak"]}


def free(st: State) -> None:
    del st.step


def leaf_gaps(side: Dict[str, float], want: Dict[str, float], names) -> Dict[str, float]:
    """Per leaf |side - want| over the larger of the reference leaf's norm
    and the median leaf's."""
    med = float(np.median([want[k] for k in names]))
    return {k: abs(side[k] - want[k]) / max(want[k], med, 1e-30) for k in names}


def _reference(st: State, ctx: harness.Context, precision=None) -> dict:
    """The reference's first steps from the seed's weights on the same
    batches and draws: its losses, first gradients and trained parameters
    after them, on the host; in `precision` (None: float32)."""
    model, data, hub = common.model_blocks(ctx)
    k = int(ctx.traffic["check_steps"])
    gw = weights.draw(model, data, hub, ctx.seed, ctx.device)
    dw = weights.draw_specs(ref_train.disc_specs(model), st.seeds["disc"], ctx.device)
    out = ref_train.train_steps(gw, dw, st.cfg_json, hub, st.batches[:k], st.draws[:k],
                                st.seeds["step"], precision=precision)
    after = {**{"gen." + n: v for n, v in gw.items() if ref_train.trainable(n)},
             **{"disc." + n: v for n, v in dw.items()}}
    side = {"losses": [(float(g), float(d)) for g, d in zip(out["g_total"], out["d_total"])],
            "grad1": {n: v.cpu() for n, v in out["grads"].items()},
            "p3": {n: v.cpu() for n, v in after.items()}}
    del gw, dw, out, after
    return side


def _norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in ts.items()}


# compared (PERF.md gives the readings each limit was set from); reported
# beside them: the losses and the worst leaf's gradient gap
NUMBERS = ("grad_gap_median", "change_gap_median", "change_gap_worst")
REPORTED = ("loss_gap_first", "loss_gap", "grad_gap", "grad_leaf", "change_leaf")


def compare(side: dict, truth: dict, p0: Dict[str, torch.Tensor]) -> dict:
    """The numbers of `side` (the program's first steps, or the control's)
    against `truth` (the fp32 reference's): the relative gap of the first
    step's G and D totals, the larger (and that of any step); over the
    leaves the reference moves (its first gradient at least a thousandth of
    the median leaf's), the median (and the worst) leaf's gap between
    first-gradient norms and between the norms of the change over the
    steps, each over the larger of the reference leaf's norm and the median
    leaf's."""
    gaps = [[abs(p - r) / max(abs(r), 1e-30) for p, r in zip(pr, rr)]
            for pr, rr in zip(side["losses"], truth["losses"])]
    g_ref, g_side = _norms(truth["grad1"]), _norms(side["grad1"])
    med_g = float(np.median(list(g_ref.values())))
    moved = sorted(n for n in g_ref if g_ref[n] >= 1e-3 * med_g)
    grad = leaf_gaps({n: g_side.get(n, 0.0) for n in g_ref}, g_ref, moved)
    d_ref = {n: float(torch.linalg.vector_norm((truth["p3"][n] - p0[n]).double())) for n in moved}
    d_side = {n: float(torch.linalg.vector_norm((side["p3"][n] - p0[n]).double()))
              for n in moved}
    change = leaf_gaps(d_side, d_ref, moved)
    return {"loss_gap_first": max(gaps[0]), "loss_gap": max(max(g) for g in gaps),
            "grad_gap": max(grad.values()), "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap_worst": max(change.values()),
            "change_gap_median": float(np.median(list(change.values()))),
            "grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get),
            "losses": side["losses"], "ref_losses": truth["losses"],
            "left_out": sorted(set(g_ref) - set(moved))}


def numbers(res: harness.WindowResult, ctx: harness.Context, control: bool = False):
    """The three compared numbers of the program's first steps against the
    fp32 reference's; with `control`, of the reference in fp8 (per-tensor
    scaled e4m3 products) in the program's place."""
    st = res.data["state"]
    truth = _reference(st, ctx)
    side = _reference(st, ctx, "fp8") if control else \
        {"losses": st.losses, "grad1": st.grad1, "p3": st.p3}
    r = compare(side, truth, st.p0)
    nums = {name: r[name] for name in NUMBERS}
    notes = {k: r[k] for k in REPORTED + ("losses", "ref_losses")}
    notes["left_out"] = r["left_out"]
    notes["failed_errors"] = res.data["errors"][:3]
    return nums, notes
