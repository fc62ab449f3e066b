"""The readings a cell's correctness limit is set from, on the card.

    python3 benchmark/readings.py --workload vc_xl.convert --seconds 8 \
        --seeds 11,12,...  --control-seeds 11,12,13

For each seed, in one process: the cell's set-up and a window of --seconds
at the cell's own load, the program freed, then the numbers the check
compares (the loop's `numbers`) of the program against the plain
reference, and for a control seed those of the control: the reference one
precision below the configuration's, put in the program's place, on the
same inputs. With --fault, a fault of benchmark/faults.py is planted under
the timed path for the whole run. One JSON line a seed; the benchmark's
own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [q for q in sys.path if os.path.abspath(q or ".") not in (here, ROOT)]
    import torch

    import contextlib

    from benchmark import faults, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.load_context(ROOT, args.workload, seed, args.seconds, False)
        ctx.device = harness.require_cards(int(ctx.workload["chips"]))
        drv = harness.loop_of(ctx)
        planted = faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        with planted:
            st = drv.setup(ctx)
            res = drv.window(st, ctx)
        drv.free(st)
        del st
        gc.collect()
        torch.cuda.empty_cache()
        nums, notes = drv.numbers(res, ctx)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault or None,
                "attempted": res.attempted, "failed": res.failed, "program": nums,
                "notes": notes}
        if seed in control:
            line["control"], line["control_notes"] = drv.numbers(res, ctx, control=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
