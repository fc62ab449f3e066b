"""The `path|sid` filelist (the port's copy of vcvits_tpu/data/filelist.py's
`load_filelist`)."""

from __future__ import annotations

from typing import List, Tuple


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
