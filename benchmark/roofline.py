"""The H100's peaks and the least time a kernel's work can take on it.

Frozen copies of chip_smoke.py's `bound_ms` and `mrf_bound_ms` (K1's
bound: bytes of the input, the output and the weights once; operations
2 * n_w * C^2 * T * B; fp32 the lesser of CUDA-core FMAs and 3xTF32 on
the tensor cores). Peaks are NVIDIA's data sheet for the H100 SXM, dense,
at its 700 W limit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12     # CUDA cores
TF32_FLOPS = 495e12    # tensor cores, dense
BF16_FLOPS = 989e12    # tensor cores, dense

# the peak an MFU is taken against, by the dtype a path computes in: fp32
# convolutions and products may run as TF32, and K1/K2 run 3xTF32, on the
# tensor cores, so no fp32 path can pass the TF32 peak
MFU_PEAK = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS}


def bound_ms(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mrf_bound_ms(t: int, c: int, n_w: int, dtype: str, b: int = 1):
    """K1's least time for one stage [b, t, c] -> (bound_ms, bound_by,
    cuda_core_ms, tf32x3_ms); the last two None in bf16."""
    isz = 4 if dtype == "float32" else 2
    nbytes = 2 * b * t * c * isz + (n_w * c * c + 2 * 9 * c) * isz
    flops = 2 * n_w * c * c * t * b
    if dtype == "bfloat16":
        return (*bound_ms(flops, nbytes, BF16_FLOPS), None, None)
    cores, cores_by = bound_ms(flops, nbytes, FP32_FLOPS)
    tc, tc_by = bound_ms(3 * flops, nbytes, TF32_FLOPS)
    return (cores, cores_by, cores, tc) if cores <= tc else (tc, tc_by, cores, tc)


def mrf_taps(kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]) -> int:
    """C x C taps of one MRF stage: two convs of k taps per (block, dilation)."""
    return 2 * sum(k * len(d) for k, d in zip(kernel_sizes, dilations))


def decoder_mrf_bound_ms(model: dict, b: int, t: int, dtype: str) -> float:
    """K1's least time over every stage of one decode of a [b, t, inter]
    latent: stage i runs at t * prod(u[:i + 1]) rows and c0 / 2^(i + 1)
    channels."""
    n_w = mrf_taps(model["resblock_kernel_sizes"], model["resblock_dilation_sizes"])
    c0 = model["upsample_initial_channel"]
    total, rows = 0.0, t
    for i, u in enumerate(model["upsample_rates"]):
        rows *= u
        total += mrf_bound_ms(rows, c0 // 2 ** (i + 1), n_w, dtype, b)[0]
    return total
