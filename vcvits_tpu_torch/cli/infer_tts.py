"""TTS synthesis CLI of the port: text -> 48 kHz wav on the card (the
counterpart of vcvits_tpu/cli/infer_tts.py):

    python -m vcvits_tpu_torch.cli.infer_tts "Hello world." out.wav --workdir logs_tts --sid 0
    python -m vcvits_tpu_torch.cli.infer_tts --text-file lines.txt outdir/ --workdir logs_tts

The generator is the latest checkpoint (or --step) of the TTS training run
in --workdir (`TTSSynthesizer.from_checkpoint`), with the run's config.json
unless -c names one. Several texts write utt_0000.wav ... into the output
directory, text i with seed --seed + i. It computes in float32 with TF32
off. --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("text", nargs="*", help="text(s) to synthesize; or use --text-file")
    p.add_argument("output", help="output wav, or a directory when synthesizing several texts")
    p.add_argument("--text-file", default=None,
                   help="file with one utterance per line (# comments skipped); combined with "
                        "positional texts")
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--noise-scale", type=float, default=0.667)
    p.add_argument("--noise-scale-w", type=float, default=0.8)
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None,
                   help="decoder frame budget (default: 20 per padded token)")
    p.add_argument("--workdir", default="logs_tts")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    p.add_argument("--cleaners", nargs="+", default=["english_cleaners"],
                   help="text cleaners, as in training")
    p.add_argument("--add-blank", action="store_true",
                   help="intersperse blank tokens (as in training)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card), or cpu for the plain PyTorch path")
    return p, p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    parser, args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    texts = list(args.text)
    if args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            lines = [ln.strip() for ln in f]
        texts += [ln for ln in lines if ln and not ln.startswith("#")]
    if not texts:
        parser.error("no text given (positional or --text-file)")

    import torch

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer_tts import TTSSynthesizer

    # float32 means float32: TF32 off in cuDNN's convolutions and in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config) if args.config else None
    tts = TTSSynthesizer.from_checkpoint(
        args.workdir, cfg=cfg, step=args.step, cleaners=tuple(args.cleaners),
        add_blank=args.add_blank, device=args.device)
    if len(texts) > 1:
        os.makedirs(args.output, exist_ok=True)
        outs = [os.path.join(args.output, f"utt_{i:04d}.wav") for i in range(len(texts))]
    else:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        outs = [args.output]
    # a seed per utterance: repeated lines get their own (reproducible) noise
    for i, (text, out) in enumerate(zip(texts, outs)):
        tts.synthesize_to_file(text, out, sid=args.sid, noise_scale=args.noise_scale,
                               noise_scale_w=args.noise_scale_w, length_scale=args.length_scale,
                               seed=args.seed + i, max_frames=args.max_frames)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
