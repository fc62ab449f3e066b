"""TTS training CLI of the port (the counterpart of
vcvits_tpu/cli/train_tts.py). Filelist lines are "path|sid|text".

    python -m vcvits_tpu_torch.cli.train_tts -c configs/48k_base.json \
        --filelist filelists/tts_train.txt --workdir logs_tts

Trains `TTSTrainer` on the card, resuming from the latest checkpoint of
--workdir. `"fp16_run": true` (the shipped configs) or --bf16 computes in
bfloat16, float32 otherwise; what stays float32 runs with TF32 off.
--device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", default="configs/48k_base.json")
    p.add_argument("--filelist", required=True)
    p.add_argument("--workdir", default="logs_tts")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 (also selected by \"fp16_run\": true)")
    p.add_argument("--cleaners", nargs="+", default=["english_cleaners"])
    p.add_argument("--add-blank", action="store_true",
                   help="intersperse blank ids between symbols (VITS's data.add_blank)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card), or cpu for the plain PyTorch path")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.train.tts_trainer import TTSTrainer

    cfg = load_config(args.config)
    dtype = torch.bfloat16 if (args.bf16 or cfg.train.fp16_run) else torch.float32
    # float32 means float32: TF32 off in cuDNN's convolutions and in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = TTSTrainer(cfg, workdir=args.workdir, device=args.device, dtype=dtype,
                         cleaners=args.cleaners, add_blank=args.add_blank)
    trainer.fit(args.filelist, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
