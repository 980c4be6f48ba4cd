"""Published peaks of one NVIDIA H100 SXM and the least time of a piece of
work at them (NVIDIA's data sheet: dense rates, 700 W)."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # dense, tensor cores


def bound(num_bytes: float, flops: float, bf16_flops: float = 0.0):
    """(least seconds, 'bytes' or 'operations'): the largest of the bytes
    at the memory rate, the float32 operations at the float32 rate and the
    bf16 tensor-core operations at the bf16 rate (CUDA cores and tensor
    cores run at once, so their times are not added)."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S
    t_ops = max(flops / PEAK_FP32_FLOPS, bf16_flops / PEAK_BF16_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
