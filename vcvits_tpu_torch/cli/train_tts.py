"""TTS training CLI of the port (the counterpart of
vcvits_tpu/cli/train_tts.py). Filelist lines are "path|sid|text".

    python -m vcvits_tpu_torch.cli.train_tts -c configs/48k_base.json \
        --filelist filelists/tts_train.txt --workdir logs_tts

Trains `TTSTrainer` on the card, resuming from the latest checkpoint of
--workdir. `"fp16_run": true` (the shipped configs) or --bf16 computes in
bfloat16, float32 otherwise; what stays float32 runs with TF32 off.
--device cpu runs the plain PyTorch path. Under torchrun (one process per
GPU) --distributed trains data-parallel, as JAX's TTS trainer:

    torchrun --nproc-per-node 2 -m vcvits_tpu_torch.cli.train_tts \
        -c configs/48k_base.json --filelist tts.txt --distributed
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
    p.add_argument("--cleaners", nargs="+", default=None,
                   help="text cleaners (default: the config's data.text_cleaners, none where "
                        "its data.cleaned_text is true, else english_cleaners)")
    p.add_argument("--add-blank", action="store_true",
                   help="intersperse blank ids between symbols (also selected by the config's "
                        "data.add_blank, VITS's key)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card), or cpu for the plain PyTorch path")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (data parallelism, one process per GPU)")
    return p.parse_args(argv)


def text_cleaners(given: Optional[List[str]], data) -> List[str]:
    """The cleaners asked for, else the config's: none for a filelist of
    cleaned text (VITS's data.cleaned_text), its data.text_cleaners, else
    english_cleaners."""
    if given is not None:
        return list(given)
    if data.cleaned_text:
        return []
    return list(data.text_cleaners or ["english_cleaners"])


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    import torch.distributed as dist

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.parallel.mesh import distributed_init, local_device
    from vcvits_tpu_torch.train.tts_trainer import TTSTrainer

    cfg = load_config(args.config)
    if args.distributed:
        distributed_init()
    dtype = torch.bfloat16 if (args.bf16 or cfg.train.fp16_run) else torch.float32
    # float32 means float32: TF32 off in cuDNN's convolutions and in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = TTSTrainer(cfg, workdir=args.workdir, device=local_device(args.device),
                         dtype=dtype, cleaners=text_cleaners(args.cleaners, cfg.data),
                         add_blank=args.add_blank or cfg.data.add_blank)
    trainer.fit(args.filelist, max_steps=args.max_steps)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
