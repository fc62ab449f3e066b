"""Train/valid/test splitter CLI of the port (the counterpart of
vcvits_tpu/cli/split.py: shuffle seed 1234, hold out 10 valid + 10 test):

    python -m vcvits_tpu_torch.cli.split --filelist filelists/audio_filelist.txt

Writes <filelist>_train.txt, <filelist>_valid.txt and <filelist>_test.txt.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--filelist", default="filelists/audio_filelist.txt")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--n-valid", type=int, default=10)
    p.add_argument("--n-test", type=int, default=10)
    args = p.parse_args(argv)

    from vcvits_tpu_torch.data.filelist import split_filelist

    with open(args.filelist, encoding="utf-8") as f:
        lines = [line.strip() for line in f if line.strip()]
    train, valid, test = split_filelist(lines, args.seed, args.n_valid, args.n_test)
    base = args.filelist.rsplit(".", 1)[0]
    for name, subset in (("train", train), ("valid", valid), ("test", test)):
        out = f"{base}_{name}.txt"
        with open(out, "w", encoding="utf-8") as f:
            f.write("\n".join(subset) + ("\n" if subset else ""))
        print(f"{out}: {len(subset)}")


if __name__ == "__main__":
    main()
