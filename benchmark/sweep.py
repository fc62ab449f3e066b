"""Find the knee of an open-loop serving cell on the card: the highest
offered rate whose completions keep up, with no backlog growing over the
window.

    python3 benchmark/sweep.py --config vc48k_base --traffic serve_poisson24 \
        --seed 5 --seconds 20 --rates 20,30,40,50

One process, one set-up a rate (the mix's other parameters as its file
has them; the configuration is one that BENCHMARK.json names). Per rate one JSON line: requests sent and completed, the
p50 and p95 from the due time, the daemon's mean batch, and the latency of
the first and last fifths of the window's requests by due time (a backlog
that grows makes the last fifth's far higher). The cell's rate is then set
at about 0.8 of the knee.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [q for q in sys.path if os.path.abspath(q or ".") not in (here, ROOT)]
    import torch

    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for rate in (float(r) for r in args.rates.split(",")):
        cell = {"name": f"{args.config}.{args.traffic}", "config": args.config,
                "traffic": args.traffic, "chips": 1}
        ctx = harness.cell_context(ROOT, cell, args.seed, args.seconds, False)
        ctx.device = harness.require_cards(int(ctx.workload["chips"]))
        ctx.traffic["rate"] = rate
        drv = harness.loop_of(ctx)
        st = drv.setup(ctx)
        res = drv.window(st, ctx)
        lat = res.data["lat"]
        n = len(lat)
        fifth = max(n // 5, 1)
        print(json.dumps({
            "rate": rate, "sent": res.attempted, "completed": res.completed,
            "p50_ms": np.percentile(lat, 50) * 1e3,
            "p95_ms": np.percentile(lat, 95) * 1e3,
            "first_fifth_p50_ms": np.percentile(lat[:fifth], 50) * 1e3,
            "last_fifth_p50_ms": np.percentile(lat[-fifth:], 50) * 1e3,
            "mean_batch": res.data["mean_batch"], "window_s": res.window_s,
            "lag_s": res.data["lag_s"]}), flush=True)
        drv.free(st)
        del st, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
