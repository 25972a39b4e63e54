"""The card's published peaks and a kernel's bound.

NVIDIA's H100 SXM data sheet, at 700 W: 67 TFLOP/s of float32 outside the
tensor cores and 3.35 TB/s of HBM.  A kernel's bound is the larger of its
float32 operations over the first and its bytes over the second, each
input read once and each output written once.
"""

from __future__ import annotations

F32_PEAK = 67e12
HBM_PEAK = 3.35e12


def kernel_bound(ops: float, nbytes: float) -> float:
    """The least seconds the card could take for ``ops`` float32 operations
    and ``nbytes`` bytes of device memory traffic."""
    return max(ops / F32_PEAK, nbytes / HBM_PEAK)
