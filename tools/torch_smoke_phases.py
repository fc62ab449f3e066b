#!/usr/bin/env python3
"""Some of chip_smoke.py's slice-11 phases alone, for iterating on them.

    python3 tools/torch_smoke_phases.py base_json,multi_gpu,torchrun

Builds the kernels, then runs the named phases (any of base_json,
multi_gpu, torchrun) with chip_smoke.py's own functions, each with its
seconds. base_json prints each kernel's max |err| on the path's inputs.
It prints no kernels line and no result line: chip_smoke.py stays the one
end-to-end check. Exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_smoke_phases: no CUDA device is available", file=sys.stderr)
        return 1
    from vcvits_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = chip_smoke.info_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.build_phase(_build)
    for name in sys.argv[1].split(","):
        t0 = time.perf_counter()
        if name == "base_json":
            held = {}
            chip_smoke.base_json_phase(dev, _build, card, held)
            print(f"base_json: each kernel's max |err| on the path's inputs {held}")
        elif name == "multi_gpu":
            chip_smoke.multi_gpu_phase(dev, _build, card)
        elif name == "torchrun":
            from vcvits_tpu_torch.config import load_config
            from vcvits_tpu_torch.data.dataset import VoiceConversionDataset, preprocess

            with tempfile.TemporaryDirectory() as tmp:
                train_fl, val_fl = chip_smoke.write_corpus(tmp, n_train=16, n_val=2)
                data = load_config(chip_smoke.CONFIG).data
                for fl in (train_fl, val_fl):
                    preprocess(VoiceConversionDataset(fl, data, cache_dir=os.path.join(
                        tmp, "cache")), num_workers=8, log_every=0)
                chip_smoke.torchrun_phase(train_fl, val_fl, os.path.join(tmp, "cache"), tmp,
                                          card)
        else:
            raise ValueError(f"no phase {name!r}")
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
