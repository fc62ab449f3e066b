"""The least time of the TTS path's kernel M1 (monotonic alignment search)
on the H100, beside benchmark/roofline.py's peaks.

A frozen copy of chip_smoke.py's M1 bound: a compare and an add a valid
score, the valid scores read once (4 bytes each) and the whole float32
path [B, T_x, T_y] written once; the larger of the bytes at 3.35 TB/s and
the operations at the fp32 CUDA-core peak.
"""

from __future__ import annotations

from benchmark.roofline import FP32_FLOPS, bound_ms


def mas_bound_ms(rows: int, t_x: int, t_y: int, valid: int) -> float:
    """M1's least ms for one launch of `rows` rows padded to [t_x, t_y],
    `valid` the sum of the rows' x_len * y_len."""
    nbytes = 4 * valid + 4 * rows * t_x * t_y
    return bound_ms(2 * valid, nbytes, FP32_FLOPS)[0]
