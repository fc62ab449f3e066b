"""Inference CLI of the port: any-to-any 48 kHz voice conversion on the
card (the counterpart of vcvits_tpu/cli/infer.py):

    python -m vcvits_tpu_torch.cli.infer source.wav out.wav --sid 256 --workdir logs
    python -m vcvits_tpu_torch.cli.infer a.wav b.wav outdir/ --sid 256   # pipelined
    python -m vcvits_tpu_torch.cli.infer src.wav out.wav --vc-source-sid 3 --sid 77

The generator is the latest checkpoint of the training run in --workdir
(`VoiceConverter.from_checkpoint`), with the run's config.json unless -c
names one. --int8-decoder decodes with the int8 decoder
(--int8-decoder-mode w8a8: dynamic W8A8 on the int8 tensor cores; w8:
weight-only int8, activations in the compute dtype), on the same
checkpoint. --bf16 computes in bfloat16, float32 otherwise (TF32 off).
--device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("source", nargs="+",
                   help="source wav(s); multiple sources pipeline host prep against device "
                        "decode")
    p.add_argument("output", help="output wav, or a directory when converting multiple sources")
    p.add_argument("--sid", type=int, default=256)
    p.add_argument("--vc-source-sid", type=int, default=None,
                   help="flow-swap mode: the source audio is of this speaker; convert to --sid "
                        "through the latent flow swap")
    p.add_argument("--pitch-shift", type=int, default=0)
    p.add_argument("--noise-scale", type=float, default=1.0)
    p.add_argument("--workdir", default="logs")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card), or cpu for the plain PyTorch path")
    p.add_argument("--bf16", action="store_true", help="compute in bfloat16")
    p.add_argument("--int8-decoder", action="store_true",
                   help="int8 decoder convs (same checkpoint, small quantization noise)")
    p.add_argument("--int8-decoder-mode", choices=("w8a8", "w8"), default="w8a8",
                   help="w8a8 = dynamic int8 activations and weights on the int8 tensor cores; "
                        "w8 = weight-only int8, activations in the compute dtype")
    return p.parse_args(argv)


def quant_mode(args: argparse.Namespace):
    """The decoder's quant_int8 from --int8-decoder / --int8-decoder-mode."""
    return args.int8_decoder and (True if args.int8_decoder_mode == "w8a8" else "w8")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if len(args.source) > 1:
        # colliding basenames would overwrite one another
        names = [os.path.basename(s) for s in args.source]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise SystemExit(f"multiple sources share basename(s) {dupes}; outputs would "
                             f"overwrite: rename them or run separately")
    logging.basicConfig(level=logging.INFO)

    import torch

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter

    # float32 means float32: TF32 off in cuDNN's convolutions and in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config) if args.config else None
    vc = VoiceConverter.from_checkpoint(
        args.workdir, cfg=cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device, quant_int8=quant_mode(args))
    if len(args.source) > 1:
        os.makedirs(args.output, exist_ok=True)
    outs = [os.path.join(args.output, os.path.basename(src)) if len(args.source) > 1
            else args.output for src in args.source]
    if args.vc_source_sid is not None:
        for src, out in zip(args.source, outs):
            vc.voice_conversion(src, out, args.vc_source_sid, args.sid)
    elif len(args.source) == 1:
        vc.convert(args.source[0], outs[0], args.sid, pitch_shift=args.pitch_shift,
                   noise_scale=args.noise_scale)
    else:
        vc.convert_many([(src, out, args.sid) for src, out in zip(args.source, outs)],
                        pitch_shift=args.pitch_shift, noise_scale=args.noise_scale)
    for out in outs:
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
