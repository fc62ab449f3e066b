"""Source-length alignment (the port's copy of vcvits_tpu/data/collate.py's
`alignment_unit`)."""

from __future__ import annotations

from vcvits_tpu_torch.config import DataConfig


def alignment_unit(cfg: DataConfig) -> int:
    """Smallest source-sample count that keeps every stream frame-aligned:
    unit % hubert_downsample == 0 (pitch/HuBERT frames) and
    unit * tgt_sr % (src_sr * hop) == 0 (whole spec frames on the target).
    2560 for the 48k config (0.16 s)."""
    ds = cfg.hubert_downsample
    unit = ds
    while (unit * cfg.target_sampling_rate) % (cfg.source_sampling_rate * cfg.hop_length) != 0:
        unit += ds
    return unit
