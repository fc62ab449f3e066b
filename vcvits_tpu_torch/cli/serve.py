"""Serving CLI of the port: the micro-batching daemon over HTTP on the card
(the counterpart of vcvits_tpu/cli/serve.py).

  python -m vcvits_tpu_torch.cli.serve --workdir logs --port 8300 --max-batch 16 --window-ms 25
  # convert:
  curl -X POST --data-binary @source.wav \\
      "http://127.0.0.1:8300/convert?sid=3" -o out.wav
  # live stream (raw 16 kHz mono i16 PCM in, chunked 48 kHz i16 PCM out):
  arecord -f S16_LE -r 16000 -c 1 -t raw | \\
      curl -sN -X POST -H "Transfer-Encoding: chunked" -T - \\
      "http://127.0.0.1:8300/stream?sid=3&incremental=1" | \\
      aplay -f S16_LE -r 48000 -c 1 -t raw
  # observe:
  curl http://127.0.0.1:8300/stats

The generator is the latest checkpoint of the training run in --workdir
(`VoiceConverter.from_checkpoint`), with the run's config.json unless -c
names one. float32 runs with TF32 off; --bf16 computes in bfloat16.
--int8-decoder builds the daemon's converter with the int8 decoder
(--int8-decoder-mode w8a8, the default: dynamic W8A8 on the int8 tensor
cores; w8: weight-only); the windowed /stream decodes in that mode too, the
incremental one on the float weights, as in JAX. --data-parallel N runs
N replicas of the generator, one on each of cuda:0 .. cuda:N-1 (N of the
CPU with -a cpu), each batch's rows split over them (serving.py).
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default="logs")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("-a", "--accelerator", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the card), or cpu for the plain PyTorch path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8300)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--window-ms", type=float, default=25.0, help="micro-batch latency window")
    p.add_argument("--bf16", action="store_true", help="compute in bfloat16")
    p.add_argument("--transfer", default="f32", choices=("f32", "f16", "i16", "mulaw"),
                   help="device<->host wire format: i16 quarters the output copy (PCM-16 "
                        "precision), mulaw ships 8-bit companded codes")
    p.add_argument("--max-stream-sessions", type=int, default=4,
                   help="cap on live POST /stream sessions (excess connections get 503)")
    p.add_argument("--int8-decoder", action="store_true",
                   help="int8 decoder convs (same checkpoint, small quantization noise)")
    p.add_argument("--int8-decoder-mode", choices=("w8a8", "w8"), default="w8a8",
                   help="w8a8 = dynamic int8 activations and weights on the int8 tensor cores; "
                        "w8 = weight-only int8, activations in the compute dtype")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="replicas over N devices (cuda:0 .. cuda:N-1), a power of two")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from vcvits_tpu_torch.cli.infer import quant_mode
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.serving import ServingDaemon, serve_http

    # float32 means float32: TF32 off in cuDNN's convolutions and in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config) if args.config else None
    devices = None
    if args.data_parallel > 1:
        n = args.data_parallel
        if args.accelerator == "cuda" and n > torch.cuda.device_count():
            raise ValueError(f"--data-parallel {n} needs {n} GPUs, "
                             f"{torch.cuda.device_count()} present")
        devices = ["cpu"] * n if args.accelerator == "cpu" else [f"cuda:{i}" for i in range(n)]
    vc = VoiceConverter.from_checkpoint(
        args.workdir, cfg=cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=devices[0] if devices else args.accelerator, quant_int8=quant_mode(args))
    with ServingDaemon(vc, max_batch=args.max_batch, window_ms=args.window_ms,
                       transfer=args.transfer, devices=devices) as daemon:
        server = serve_http(daemon, host=args.host, port=args.port,
                            max_stream_sessions=args.max_stream_sessions)
        logging.info("serving on http://%s:%d (max_batch=%d window=%.0fms, %s)", args.host,
                     server.server_address[1], args.max_batch, args.window_ms, vc.device)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()
