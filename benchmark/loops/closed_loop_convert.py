"""One closed-loop client of the program's `VoiceConverter.convert_array`.

Traffic parameters (benchmark/traffic/<mix>.json): "pool" (how many
distinct requests the client cycles through), "median_s", "sigma",
"min_s", "max_s" (log-normal source lengths, clipped), "noise_scale",
"check_requests" (how many of the requests the window finished the check
compares, the longest among them) and "schedule_seed".

The pool's lengths are the log-normal's quantiles in an order drawn from
the mix's schedule_seed, the same in every run; --seed draws what the
requests hold (sources, speakers, weights, each request's noise seed).
Set-up makes the sources on the card and converts each pool request once
(every shape the window will use). The window sends the pool
in order, again and again, each request after the last returned, until the
window's seconds are up; the request in flight at the close finishes and
counts. A request is timed from the call to the returned host array.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import flops, harness, synth
from benchmark.loops import common
from benchmark.reference import vc as ref


class State:
    pass


def setup(ctx: harness.Context) -> State:
    from vcvits_tpu_torch.data.collate import alignment_unit

    tr = ctx.traffic
    model, data, hub = common.model_blocks(ctx)
    st = State()
    st.model = model
    st.vc = common.build_converter(ctx)
    n = int(tr["pool"])
    rng = np.random.default_rng([tr["schedule_seed"], 0x1E4])
    st.secs = synth.quantile_lengths(n, tr["median_s"], tr["sigma"], tr["min_s"], tr["max_s"],
                                     rng)
    st.sources = synth.make_sources(st.secs, ctx.seed, ctx.device,
                                    alignment_unit(st.vc.cfg.data), data["n_speakers"],
                                    model["num_pitch"])
    st.seeds = np.random.default_rng([ctx.seed, 0x5EED]).integers(0, 2 ** 31 - 1, n).tolist()
    st.flops = [flops.infer_flops(model, hub, len(s.wav)) for s in st.sources]
    for i, s in enumerate(st.sources):
        st.vc.convert_array(s.wav, s.pitch, s.speaker, s.true_len, tr["noise_scale"],
                            st.seeds[i])
    return st


def modules(st: State) -> dict:
    return {"enc_p": st.vc.gen.enc_p, "dec": st.vc.gen.dec}


def window(st: State, ctx: harness.Context) -> harness.WindowResult:
    tr = ctx.traffic
    n = len(st.sources)
    lat, done, outs, errors = [], [], {}, []
    t0 = time.perf_counter()
    close = t0 + ctx.seconds
    i = 0
    while time.perf_counter() < close:
        k = i % n
        s = st.sources[k]
        t_a = time.perf_counter()
        try:
            with torch.autograd.profiler.record_function("bench.convert_array"):
                out = st.vc.convert_array(s.wav, s.pitch, s.speaker, s.true_len,
                                          tr["noise_scale"], st.seeds[k])
        except Exception as e:  # noqa: BLE001 - a failed request, counted
            errors.append(repr(e))
        else:
            lat.append(time.perf_counter() - t_a)
            done.append(k)
            if k not in outs:
                outs[k] = out
        i += 1
    t_end = time.perf_counter()
    return harness.WindowResult(attempted=i, failed=i - len(done), window_s=t_end - t0,
                                completed=len(done),
                                data={"lat": lat, "done": done, "outs": outs,
                                      "errors": errors, "state": st})


def end_to_end(st: State, res: harness.WindowResult) -> dict:
    lat = res.data["lat"] or [res.window_s]
    return {"convert_p95_ms": float(np.percentile(lat, 95)) * 1e3}


def record(st: State, res: harness.WindowResult) -> dict:
    return {"completed": res.completed,
            "flops": float(sum(st.flops[k] for k in res.data["done"])),
            "dtype": "float32", "model": st.model,
            "dec_inputs": [(1, int(round(len(st.sources[k].wav) * ref.LENGTH_SCALE)))
                           for k in res.data["done"]]}


def free(st: State) -> None:
    del st.vc


def cases(res: harness.WindowResult, ctx: harness.Context):
    """The sampled finished requests' cases (and None: a closed loop has no
    batches to misorder)."""
    st = res.data["state"]
    finished = sorted(res.data["outs"])
    picked = common.sample_indices(len(finished), ctx.traffic["check_requests"],
                                   st.secs[finished], ctx.seed)
    out = []
    for k in (finished[j] for j in picked):
        s = st.sources[k]
        out.append(common.Case(s.wav, s.true_len, s.pitch, s.speaker, 1, 0, st.seeds[k],
                               ctx.traffic["noise_scale"], res.data["outs"][k]))
    return out, None


def numbers(res: harness.WindowResult, ctx: harness.Context, control: bool = False):
    nums, notes = common.numbers(ctx, cases(res, ctx)[0], control)
    notes["failed_errors"] = res.data["errors"][:3]
    return nums, notes
