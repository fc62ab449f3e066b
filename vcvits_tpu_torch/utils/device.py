"""Device selection for the entry points: the card unless the CPU is asked for."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device when none is present:
    nothing continues quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev
