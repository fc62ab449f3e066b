"""The program's TTS train step, `TTSTrainStep.__call__`, step after step.

Traffic parameters (benchmark/traffic/<mix>.json): "batch_size" (rows a
step), "frames_lo" and "frames_hi" (spectrogram lengths drawn in
(frames_lo, frames_hi]), "pad_frames" (the bucket every batch is padded
to), "ids_lo" and "ids_hi" (symbol ids a text, before the blanks),
"batches" (distinct batches, cycled), "check_steps" (the steps the
reference follows) and "dtype" ("config": the configuration's
train_dtype).

Set-up draws the weights (benchmark/reference/tts.py:param_specs and
disc_specs), builds one `TTSTrainStep` in the configured compute dtype
with the configuration's vocabulary, makes the batches on the card from
the seed (benchmark/synth_tts.py) and the draws each step is given (the
posterior's noise, the duration predictor's noise and the segment starts,
as `TTSStepDraws`), then drives the step once through every batch of the
cycle: that builds every kernel and warms every shape (the text length,
padded to the batch's longest, differs from batch to batch). Of the first
`check_steps` of those steps it keeps what
the check compares, as benchmark/loops/train_steps.py does: each step's G
and D totals, the first gradient as AdamW holds it, the trained
parameters before and after. The window runs the same object on, each
step ending in a synchronise; train_step_ms is the window's wall time over
the steps it completed.

The check draws the weights again and runs benchmark/reference/tts.py's
fp32 step on the same batches and draws (its own MAS on its own scores),
and compares train_steps.py's three numbers against the cell's limits.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, synth_tts, weights
from benchmark.loops import train_steps
from benchmark.reference import tts as ref_tts

SALT = 0x7755


class State:
    pass


def _seeds(seed: int) -> dict:
    ss = np.random.default_rng([seed, SALT]).integers(0, 2 ** 31 - 1, 4).tolist()
    return {"gen": ss[0], "disc": ss[1], "data": ss[2], "step": ss[3]}


def make_draws(cfg: dict, batches: List[dict], gen: torch.Generator, device) -> List[dict]:
    """Per batch the posterior's noise [B, T_y, inter], the duration
    predictor's [B, T_x, 2] and the segment starts [B], as the program's
    generator would draw them."""
    hop = ref_tts.target_data(cfg["data"])["hop_length"]
    seg = cfg["train"]["segment_size"] // hop
    out = []
    for b in batches:
        rows, t_x = b["text"].shape
        t_y = b["y_wav"].shape[1] // hop
        eps = torch.randn((rows, t_y, cfg["model"]["inter_channels"]), generator=gen,
                          device=device)
        e_q = torch.randn((rows, t_x, 2), generator=gen, device=device)
        u = torch.rand(rows, generator=gen, device=device)
        top = torch.clamp_min((b["y_wav_lengths"] // hop).to(torch.int32) - seg + 1, 1)
        out.append({"eps": eps, "e_q": e_q,
                    "ids_str": torch.floor(u * top.to(u.dtype)).to(torch.int32)})
    return out


def _named(step) -> Dict[str, torch.nn.Parameter]:
    return {**{"gen." + k: p for k, p in step.gen.named_parameters()},
            **{"disc." + k: p for k, p in step.disc.named_parameters()}}


def _weights(ctx: harness.Context, seeds: dict):
    cfg = ctx.config["config"]
    gw = weights.draw_specs(ref_tts.param_specs(cfg["model"], cfg["data"]), seeds["gen"],
                            ctx.device)
    dw = weights.draw_specs(ref_tts.disc_specs(cfg["model"]), seeds["disc"], ctx.device)
    return gw, dw


def setup(ctx: harness.Context) -> State:
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep

    tr, cfg_json = ctx.traffic, ctx.config["config"]
    seeds = _seeds(ctx.seed)
    st = State()
    st.cfg_json, st.seeds, st.dtype = cfg_json, seeds, train_steps._dtype(ctx)
    cfg = Config.from_dict(cfg_json)
    gw, dw = _weights(ctx, seeds)
    st.step = TTSTrainStep(cfg, device=ctx.device, seed=seeds["step"], g_state=gw, d_state=dw,
                           dtype=st.dtype)
    del gw, dw
    gen = torch.Generator(device=ctx.device).manual_seed(seeds["data"])
    data, model = ref_tts.target_data(cfg_json["data"]), cfg_json["model"]
    st.batches = [synth_tts.make_tts_batch(
        int(tr["batch_size"]), int(tr["frames_lo"]), int(tr["frames_hi"]), int(tr["pad_frames"]),
        int(tr["ids_lo"]), int(tr["ids_hi"]), model["n_vocab"], data["n_speakers"],
        data["hop_length"], data["target_sampling_rate"], gen, ctx.device)
        for _ in range(int(tr["batches"]))]
    st.draws = make_draws(cfg_json, st.batches, gen, ctx.device)
    named = _named(st.step)
    st.p0 = {k: p.detach().cpu().clone() for k, p in named.items()}
    st.losses = []
    k = int(tr["check_steps"])
    beta1 = cfg_json["train"]["betas"][0]
    for i in range(k):
        m = st.step(st.batches[i], TTSStepDraws(**st.draws[i]))
        st.losses.append((float(m["loss/g/total"]), float(m["loss/d/total"])))
        if i == 0:
            st.grad1 = {name: (opt.state[p]["exp_avg"] / (1 - beta1)).cpu()
                        for opt in (st.step.g_opt, st.step.d_opt)
                        for name, p in named.items() if p in opt.state}
    st.p3 = {k: p.detach().cpu().clone() for k, p in named.items()}
    # the other batches' text lengths warmed too: the window meets no new shape
    for i in range(k, len(st.batches)):
        st.step(st.batches[i], TTSStepDraws(**st.draws[i]))
    st.next = len(st.batches)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return st


def modules(st: State) -> dict:
    return {"gen": st.step.gen, "disc": st.step.disc}


def window(st: State, ctx: harness.Context) -> harness.WindowResult:
    from vcvits_tpu_torch.train.tts_step import TTSStepDraws

    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    n = len(st.batches)
    steps, failed, errors, shapes = 0, 0, [], []
    t0 = time.perf_counter()
    close = t0 + ctx.seconds
    while time.perf_counter() < close:
        i = (st.next + steps + failed) % n
        try:
            st.step(st.batches[i], TTSStepDraws(**st.draws[i]))
            if on_card:
                torch.cuda.synchronize()
            steps += 1
            shapes.append(i)
        except Exception as e:  # noqa: BLE001 - a failed step, counted
            failed += 1
            errors.append(repr(e))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    return harness.WindowResult(attempted=steps + failed, failed=failed, window_s=wall,
                                completed=steps,
                                data={"errors": errors, "peak": peak, "state": st,
                                      "batches_run": shapes})


def end_to_end(st: State, res: harness.WindowResult) -> dict:
    return {"train_step_ms": res.window_s * 1e3 / max(res.completed, 1)}


def record(st: State, res: harness.WindowResult) -> dict:
    """The window's operations (benchmark/flops_tts.py, per batch of the
    cycle) and M1's inputs a step: (rows, T_x, T_y, sum of the rows'
    x_len * y_len) for benchmark/metrics/m1_roofline.tts_train.py."""
    from benchmark import flops_tts

    hop = ref_tts.target_data(st.cfg_json["data"])["hop_length"]
    per = {}
    mas = []
    for i in res.data["batches_run"]:
        b = st.batches[i]
        if i not in per:
            per[i] = flops_tts.train_step_flops(st.cfg_json, tuple(b["text"].shape),
                                                tuple(b["y_wav"].shape))
        xl = b["text_lengths"].long()
        yl = (b["y_wav_lengths"] // hop).long()
        mas.append((b["text"].shape[0], b["text"].shape[1], b["y_wav"].shape[1] // hop,
                    int(torch.sum(xl * yl))))
    return {"completed": res.completed, "steps": res.completed,
            "flops": sum(per[i] for i in res.data["batches_run"]),
            "dtype": "bfloat16" if st.dtype == torch.bfloat16 else "float32",
            "peak_bytes": res.data["peak"], "mas_inputs": mas}


def free(st: State) -> None:
    del st.step


def _reference(st: State, ctx: harness.Context, precision=None) -> dict:
    """The reference's first steps from the seed's weights on the same
    batches and draws, on the host; in `precision` (None: float32)."""
    k = int(ctx.traffic["check_steps"])
    gw, dw = _weights(ctx, st.seeds)
    out = ref_tts.train_steps(gw, dw, st.cfg_json, st.batches[:k], st.draws[:k],
                              st.seeds["step"], precision=precision)
    after = {**{"gen." + n: v for n, v in gw.items()}, **{"disc." + n: v for n, v in dw.items()}}
    side = {"losses": [(float(g), float(d)) for g, d in zip(out["g_total"], out["d_total"])],
            "grad1": {n: v.cpu() for n, v in out["grads"].items()},
            "p3": {n: v.cpu() for n, v in after.items()}}
    del gw, dw, out, after
    return side


def numbers(res: harness.WindowResult, ctx: harness.Context, control: bool = False):
    """train_steps.py's three compared numbers of the program's first steps
    against the fp32 reference's; with `control`, of the reference in fp8
    in the program's place."""
    st = res.data["state"]
    truth = _reference(st, ctx)
    side = _reference(st, ctx, "fp8") if control else \
        {"losses": st.losses, "grad1": st.grad1, "p3": st.p3}
    r = train_steps.compare(side, truth, st.p0)
    nums = {name: r[name] for name in train_steps.NUMBERS}
    notes = {k: r[k] for k in train_steps.REPORTED + ("losses", "ref_losses")}
    notes["left_out"] = r["left_out"]
    notes["failed_errors"] = res.data["errors"][:3]
    return nums, notes
