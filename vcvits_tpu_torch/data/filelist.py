"""Filelist generation, train/valid/test splitting and the `path|sid`
reader: the port's copy of vcvits_tpu/data/filelist.py.

`generate_filelist` scans dataset/<speaker>/*.wav, keeps the speakers with
more than `min_files_per_speaker` clips of at least `min_seconds` and
emits "path|sid" lines and the speaker names; `split_filelist` shuffles
with a seed and holds out the last n_valid + n_test lines, as the
reference's filelist.py and split.py do.
"""

from __future__ import annotations

import os
import random
import struct
from typing import List, Tuple


def wav_duration_seconds(path: str) -> float:
    """A WAV's duration from its fmt and data chunk sizes, with no sample
    decoded; 0.0 for a file that is not a readable RIFF WAV."""
    try:
        with open(path, "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF":
                return 0.0
            sr = None
            block_align = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return 0.0
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = f.read(csize)
                    _, _, sr, _, block_align, _ = struct.unpack("<HHIIHH", fmt[:16])
                elif cid == b"data":
                    if sr and block_align:
                        return csize / (sr * block_align)
                    return 0.0
                else:
                    f.seek(csize + (csize & 1), 1)
    except OSError:
        return 0.0


def generate_filelist(dataset_dir: str, min_files_per_speaker: int = 50,
                      min_seconds: float = 3.0) -> Tuple[List[str], List[str]]:
    """Returns (["path|sid", ...], [speaker_name, ...])."""
    lines: List[str] = []
    speakers: List[str] = []
    sid = 0
    for name in sorted(os.listdir(dataset_dir)):
        spk_dir = os.path.join(dataset_dir, name)
        if not os.path.isdir(spk_dir):
            continue
        wavs = sorted(os.path.join(spk_dir, w) for w in os.listdir(spk_dir) if w.endswith(".wav"))
        wavs = [w for w in wavs if wav_duration_seconds(w) >= min_seconds]
        if len(wavs) <= min_files_per_speaker:
            continue
        lines.extend(f"{w}|{sid}" for w in wavs)
        speakers.append(name)
        sid += 1
    return lines, speakers


def split_filelist(lines: List[str], seed: int = 1234, n_valid: int = 10, n_test: int = 10
                   ) -> Tuple[List[str], List[str], List[str]]:
    """(train, valid, test): the lines shuffled with `seed`, the last
    n_valid + n_test held out."""
    lines = list(lines)
    random.Random(seed).shuffle(lines)
    n_hold = n_valid + n_test
    return lines[:-n_hold], lines[-n_hold:-n_test], lines[-n_test:]


def load_filelist(path: str) -> List[Tuple[str, int]]:
    """"path|sid" lines -> [(path, sid)]; a missing sid reads as 0."""
    items = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if not parts or not parts[0]:
                continue
            items.append((parts[0], int(parts[1]) if len(parts) > 1 else 0))
    return items
