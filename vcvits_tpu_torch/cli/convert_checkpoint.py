"""Convert checkpoints in both directions between the reference (PyTorch
Lightning) format and the port's checkpoint directories (the counterpart
of vcvits_tpu/cli/convert_checkpoint.py).

Import (reference -> port; the default):
  python -m vcvits_tpu_torch.cli.convert_checkpoint path/to/last.ckpt \\
      -c configs/48k_base.json --workdir logs_converted

Export (port -> a reference-style torch .ckpt, for A/B against the reference):
  python -m vcvits_tpu_torch.cli.convert_checkpoint --export out.ckpt --workdir logs \\
      -c configs/48k_base.json

An imported checkpoint holds the converted generator and discriminators
with fresh optimizers, at --step (0 by default), beside the config as
config.json: `cli.train --workdir` resumes from it and `cli.infer
--workdir` converts with it. Runs on the host; no GPU is needed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="reference Lightning .ckpt path (import mode)")
    p.add_argument("-c", "--config", default="configs/48k_base.json")
    p.add_argument("--workdir", default="logs_converted",
                   help="the port's run directory (output for import, input for --export)")
    p.add_argument("--step", type=int, default=None,
                   help="step to store under (import) / load (export)")
    p.add_argument("--export", default=None, metavar="OUT_CKPT",
                   help="export the workdir's latest checkpoint to a torch .ckpt with the "
                        "reference's key naming")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    cfg = load_config(args.config)
    mgr = CheckpointManager(os.path.join(args.workdir, "checkpoints"))

    if args.export:
        from vcvits_tpu_torch.convert.export_torch import export_lightning_checkpoint

        step = args.step if args.step is not None else mgr.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint under {mgr.directory}")
        state = mgr.restore(step)
        sd = export_lightning_checkpoint(args.export, state["gen"], cfg, state.get("disc"))
        print(f"exported step {step} -> {args.export} ({len(sd)} tensors, reference key "
              f"naming: net_g.* / net_period_d.* / net_scale_d.*)")
        return

    if args.checkpoint is None:
        raise SystemExit("provide a reference .ckpt to import, or --export")

    from vcvits_tpu_torch.convert.vcvits_torch import convert_lightning_checkpoint
    from vcvits_tpu_torch.train.step import TrainStep

    gen, disc = convert_lightning_checkpoint(args.checkpoint, cfg)
    if disc is None:
        raise SystemExit("checkpoint has no discriminators; cannot build the full train state")
    step = args.step if args.step is not None else 0
    train_step = TrainStep(cfg, device="cpu", g_state=gen, d_state=disc)
    state = train_step.state_dict()
    state["step"] = step
    state["accum"]["updates"] = step
    with open(os.path.join(args.workdir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=1)
    mgr.save(step, state)
    mgr.wait()
    print(f"converted -> {args.workdir} (step {step}); resume training with "
          f"python -m vcvits_tpu_torch.cli.train --workdir {args.workdir}, or convert with "
          f"python -m vcvits_tpu_torch.cli.infer --workdir {args.workdir}")


if __name__ == "__main__":
    main()
