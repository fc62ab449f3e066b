"""Filelist generator CLI of the port (the counterpart of
vcvits_tpu/cli/filelist.py):

    python -m vcvits_tpu_torch.cli.filelist --dataset dataset --out filelists/audio_filelist.txt

Writes "path|sid" lines for every speaker directory of --dataset with more
than --min-files clips of at least --min-seconds, and the speaker names
beside them (--speakers-out, by default <out>_speakers.txt).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="dataset")
    p.add_argument("--out", default="filelists/audio_filelist.txt")
    p.add_argument("--speakers-out", default=None)
    p.add_argument("--min-files", type=int, default=50)
    p.add_argument("--min-seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from vcvits_tpu_torch.data.filelist import generate_filelist

    lines, speakers = generate_filelist(args.dataset, min_files_per_speaker=args.min_files,
                                        min_seconds=args.min_seconds)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    speakers_out = args.speakers_out or args.out.replace(".txt", "_speakers.txt")
    with open(speakers_out, "w", encoding="utf-8") as f:
        f.write("\n".join(speakers) + ("\n" if speakers else ""))
    print(f"{len(lines)} clips across {len(speakers)} speakers -> {args.out}")


if __name__ == "__main__":
    main()
