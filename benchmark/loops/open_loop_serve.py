"""Open-loop serving: Poisson-like arrivals at a fixed rate into the
program's `ServingDaemon`, each request timed from when it was due.

Traffic parameters (benchmark/traffic/<mix>.json): "rate" (requests/s),
"median_s", "sigma", "min_s", "max_s" (log-normal source lengths, clipped),
"max_batch", "window_ms", "transfer" (the daemon's settings), "noise_scale",
"check_requests" (how many of the requests that finished the check
compares, the longest among them) and "drain_s" (how long past the window the run waits
for answers still due).

A run sends round(rate * seconds) requests. Their lengths are the
log-normal's quantiles and their gaps the exponential's quantiles, each in
an order drawn from the seed, scaled so the last is due before the window
closes: every seed offers the same work. Sources and pitch are made on the
card in set-up (benchmark/synth.py). Latency runs from the due time to the
moment the daemon resolves the request's future with its waveform on the
host; a request that fails or is still unanswered drain_s past the close
counts as missing, its latency then the time it waited.

The batches the daemon formed are read from a forward pre-hook on the
content encoder: each call's padded length and row lengths. Requests
arrive from one thread and the daemon batches them in order, so each batch
is the next requests in order, which the row lengths confirm; the check
rebuilds each sampled request's batch row and noise row from them.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import flops, harness, synth
from benchmark.loops import common
from benchmark.reference import vc as ref


class State:
    pass


def _arrivals(n: int, rate: float, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 0xA77])
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / max(due[-1] + gaps[-1], 1e-9))


def setup(ctx: harness.Context) -> State:
    from vcvits_tpu_torch.serving import ServingDaemon

    tr = ctx.traffic
    model, data, hub = common.model_blocks(ctx)
    st = State()
    st.model = model
    st.vc = common.build_converter(ctx)
    n = max(1, int(round(tr["rate"] * ctx.seconds)))
    rng = np.random.default_rng([tr["schedule_seed"], 0x1E4])
    st.secs = synth.quantile_lengths(n, tr["median_s"], tr["sigma"], tr["min_s"], tr["max_s"],
                                     rng)
    from vcvits_tpu_torch.data.collate import alignment_unit

    st.sources = synth.make_sources(st.secs, ctx.seed, ctx.device,
                                    alignment_unit(st.vc.cfg.data), data["n_speakers"],
                                    model["num_pitch"])
    st.due = _arrivals(n, tr["rate"], ctx.seconds, tr["schedule_seed"])
    st.noise_seed = common.noise_seed(ctx.seed)
    st.flops = [flops.infer_flops(model, hub, len(s.wav)) for s in st.sources]
    st.batches = []
    st.recording = False

    def seen(_m, args):
        if st.recording:
            st.batches.append((tuple(args[0].shape), args[1]))

    st.hook = st.vc.gen.enc_p.register_forward_pre_hook(seen)
    st.daemon = ServingDaemon(st.vc, max_batch=tr["max_batch"], window_ms=tr["window_ms"],
                              transfer=tr["transfer"])
    # warm-up: a full batch of the longest sources, then each smaller batch
    # size; nothing is built or tuned later (no shape compiles eagerly)
    longest = sorted(range(n), key=lambda i: -st.secs[i])
    for size in (tr["max_batch"], 8, 4, 2, 1):
        futs = [st.daemon.submit(s.wav, s.pitch, s.true_len, s.speaker, tr["noise_scale"],
                                 st.noise_seed)
                for s in (st.sources[i] for i in (longest * 16)[:size])]
        for f in futs:
            f.result()
    return st


def modules(st: State) -> dict:
    return {"enc_p": st.vc.gen.enc_p, "dec": st.vc.gen.dec}


def window(st: State, ctx: harness.Context) -> harness.WindowResult:
    tr = ctx.traffic
    n = len(st.sources)
    done_at = [None] * n
    outs = {}
    errors = {}
    lock = threading.Lock()
    st.daemon.reset_stats()
    st.batches.clear()
    st.recording = True

    def finish(i):
        def cb(fut):
            t = time.perf_counter()
            exc = fut.exception()
            with lock:
                if exc is not None:
                    errors[i] = repr(exc)
                else:
                    done_at[i] = t
                    outs[i] = fut.result()
        return cb

    futures = []
    lag = 0.0
    t0 = time.perf_counter()
    for i, s in enumerate(st.sources):
        due = t0 + st.due[i]
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        with torch.autograd.profiler.record_function("bench.submit"):
            fut = st.daemon.submit(s.wav, s.pitch, s.true_len, s.speaker, tr["noise_scale"],
                                   st.noise_seed)
        lag = max(lag, time.perf_counter() - due)
        fut.add_done_callback(finish(i))
        futures.append(fut)
    close = t0 + ctx.seconds
    give_up = close + tr["drain_s"]
    for fut in futures:
        try:
            fut.result(timeout=max(give_up - time.perf_counter(), 0.0))
        except Exception:  # noqa: BLE001 - counted below as missing
            pass
    st.recording = False
    t_end = time.perf_counter()
    with lock:
        lat = [(done_at[i] if done_at[i] is not None else give_up) - (t0 + st.due[i])
               for i in range(n)]
        completed = [i for i in range(n) if done_at[i] is not None]
        failed = n - len(completed)
        last = max((done_at[i] for i in completed), default=t_end)
    stats = st.daemon.stats()
    return harness.WindowResult(
        attempted=n, failed=failed, window_s=max(last, close) - t0, completed=len(completed),
        data={"lat": lat, "completed": completed, "outs": outs, "errors": errors,
              "mean_batch": stats.get("mean_batch"), "batches": list(st.batches),
              "lag_s": lag, "state": st})


def end_to_end(st: State, res: harness.WindowResult) -> dict:
    return {"serve_p95_ms": float(np.percentile(res.data["lat"], 95)) * 1e3}


def record(st: State, res: harness.WindowResult) -> dict:
    return {"completed": res.completed, "mean_batch": res.data["mean_batch"],
            "flops": float(sum(st.flops[i] for i in res.data["completed"])),
            "dtype": "float32", "model": st.model,
            "dec_inputs": [(1, int(round(x * ref.LENGTH_SCALE)))
                           for _, lens in res.data["batches"]
                           for x in lens.cpu().tolist() if x > 1]}


def free(st: State) -> None:
    st.daemon.close()
    st.hook.remove()
    del st.daemon, st.vc


def cases(res: harness.WindowResult, ctx: harness.Context):
    """The sampled requests' cases, and the first disagreement between the
    recorded batches and the order of submission (None if none)."""
    st = res.data["state"]
    where = {}
    nxt = 0
    for (b_pad, t_pad), lens in res.data["batches"]:
        lens = lens.cpu().tolist()
        real = [x for x in lens if x > 1]
        for row, x in enumerate(real):
            if nxt >= len(st.sources) or st.sources[nxt].true_len != x:
                return None, f"batch row {row} of length {x} is not request {nxt}"
            where[nxt] = (b_pad, t_pad, row)
            nxt += 1
    finished = sorted(res.data["outs"])
    picked = common.sample_indices(len(finished), ctx.traffic["check_requests"],
                                   st.secs[finished], ctx.seed)
    cases = []
    for i in (finished[j] for j in picked):
        if i not in where:
            return None, f"request {i} was answered from no recorded batch"
        s = st.sources[i]
        b_pad, t_pad, row = where[i]
        wav = np.zeros(t_pad, np.float32)
        wav[:len(s.wav)] = s.wav
        pitch = np.zeros(t_pad // ref.HUBERT_DOWNSAMPLE, np.int64)
        pitch[:len(s.pitch)] = s.pitch
        cases.append(common.Case(wav, s.true_len, pitch, s.speaker, b_pad, row, st.noise_seed,
                                 ctx.traffic["noise_scale"], res.data["outs"].get(i)))
    return cases, None


def numbers(res: harness.WindowResult, ctx: harness.Context, control: bool = False):
    picked, wrong = cases(res, ctx)
    if picked is None:
        return {"batches_out_of_order": 1}, {"order": wrong}
    nums, notes = common.numbers(ctx, picked, control)
    notes.update(lag_s=res.data["lag_s"], failed_errors=list(res.data["errors"].values())[:3])
    return nums, notes
