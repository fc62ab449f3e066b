"""Training CLI of the port (the counterpart of vcvits_tpu/cli/train.py).

    python -m vcvits_tpu_torch.cli.train -c configs/48k_base.json --workdir logs

Loads the JSON config, warms the dataset caches (skip with -s), optionally
dumps precomputed HuBERT features (--preload / --preload-dump), and trains
on the card with the auto-resume of train/trainer.py. `"fp16_run": true`
(both shipped configs) or --bf16 computes in bfloat16, float32 otherwise;
`trainer.accumulate_grad_batches` mini-steps make an update. What stays
float32 (the targets, the mel loss, the optimizer) runs with TF32 off.
--hubert-ckpt loads a fairseq HuBERT checkpoint (convert/hubert_torch.py)
into the generator's frozen HuBERT before training (a resumed run keeps
its checkpoint's), and the --preload dump uses it.

Several GPUs, one process each, under torchrun:

    torchrun --nproc-per-node 4 -m vcvits_tpu_torch.cli.train \
        -c configs/base.json --workdir logs --distributed --model-parallel 2

--distributed joins torchrun's process group (parallel/mesh.py:
distributed_init; NCCL, each rank on cuda:LOCAL_RANK; without torchrun's
environment it trains on one process), and --model-parallel N shards the
layers of JAX's tensor-parallel rule over groups of N ranks; the data
axis takes gcd(batch_size, world / N) ranks, each with its rows of every
global batch (train/trainer.py). Rank 0 alone preprocesses, dumps
features and writes the run's files; the others wait for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", default="configs/48k_base.json")
    p.add_argument("-a", "--accelerator", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card), or cpu for the plain PyTorch path")
    p.add_argument("-s", "--skip-preprocess", action="store_true")
    p.add_argument("--cachedir", default=None)
    p.add_argument("--workdir", default="logs")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="override train.batch_size")
    p.add_argument("--time-limit", type=float, default=None,
                   help="wall-clock budget in seconds: checkpoint and exit at the first step "
                        "boundary past it (SIGTERM/SIGINT do the same)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of the run into this directory")
    p.add_argument("--preload", action="store_true",
                   help="train from precomputed HuBERT features (dumps missing ones first)")
    p.add_argument("--preload-dump", action="store_true",
                   help="dump precomputed HuBERT features and exit")
    p.add_argument("--preload-shift-aug", action="store_true",
                   help="random +-12 semitone source shift with p=0.7 per epoch item; with "
                        "--preload-dump, dump all 25 shift variants")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 (also selected by \"fp16_run\": true)")
    p.add_argument("--hubert-ckpt", default=None,
                   help="a fairseq HuBERT .pt for the frozen content encoder")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks that share one model (tensor parallelism); must divide the "
                        "world size")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (one process per GPU)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    import torch
    import torch.distributed as dist

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.parallel.mesh import distributed_init, local_device, local_tensor
    from vcvits_tpu_torch.data.dataset import VoiceConversionDataset, preprocess
    from vcvits_tpu_torch.utils.provenance import check_git_hash, get_logger

    cfg = load_config(args.config)
    if args.distributed:
        distributed_init()
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    dtype = torch.bfloat16 if (args.bf16 or cfg.train.fp16_run) else torch.float32
    if args.batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 batch_size=args.batch_size))
    if args.cachedir:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                cache_dir=args.cachedir))
    # float32 means float32: TF32 off in cuDNN's convolutions (PyTorch's
    # default is on) and in matmuls, as JAX's HIGHEST precision for fp32;
    # in a bf16 run this holds for what stays float32 (the targets, the
    # mel loss, the optimizer)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if main_rank:
        check_git_hash(args.workdir)
        get_logger(args.workdir).info("vcvits_tpu_torch.cli.train args: %s", vars(args))

    files = [f for f in (cfg.data.training_files, cfg.data.validation_files) if os.path.exists(f)]
    if not args.skip_preprocess and main_rank:
        for f in files:
            preprocess(VoiceConversionDataset(f, cfg.data), num_workers=8)

    from vcvits_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, workdir=args.workdir, device=local_device(args.accelerator),
                      preload=args.preload, preload_shift_aug=args.preload_shift_aug,
                      model_parallel=args.model_parallel, dtype=dtype)
    # the caches rank 0 wrote are complete before any rank reads them
    trainer.mesh.agree(False)
    if args.hubert_ckpt and trainer.train_step is not None:
        from vcvits_tpu_torch.convert.hubert_torch import load_fairseq_checkpoint
        from vcvits_tpu_torch.models.synthesizer import hubert_config_for

        whole = load_fairseq_checkpoint(args.hubert_ckpt,
                                        hubert_config_for(cfg.model.hubert_channels))
        tp = trainer.train_step.g_tp  # this rank's slices where the layers are sharded
        trainer.train_step.gen.enc_p.hubert.load_state_dict(
            {k: local_tensor(v, tp.get("enc_p.hubert." + k), trainer.mesh)
             for k, v in whole.items()})
    if args.preload or args.preload_dump:
        from vcvits_tpu_torch.data.preload import SHIFT_SET, dump_hubert_features

        if not args.hubert_ckpt:
            logging.warning("--preload without --hubert-ckpt: dumping features from the "
                            "seeded HuBERT of the trainer's generator")
        if trainer.mesh.model > 1:
            raise ValueError("--preload dumps features with a whole HuBERT: dump them with "
                             "--model-parallel 1 first")
        for f in (files if main_rank else ()):
            # shift variants for the training set only (no augmentation on validation)
            shifts = SHIFT_SET if args.preload_shift_aug and f == cfg.data.training_files \
                else (0,)
            n = dump_hubert_features(VoiceConversionDataset(f, cfg.data), cfg,
                                     trainer.train_step.gen.enc_p.hubert, pitch_shifts=shifts,
                                     device=trainer.device, dtype=dtype)
            logging.info("dumped %d HuBERT feature files for %s", n, f)
        trainer.mesh.agree(False)
        if args.preload_dump:
            return
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if trainer.device.type == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            trainer.fit(max_steps=args.max_steps, max_seconds=args.time_limit)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        trainer.fit(max_steps=args.max_steps, max_seconds=args.time_limit)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
