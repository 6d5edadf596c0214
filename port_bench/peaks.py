"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at its 700 W limit), by the element type of the work."""

from __future__ import annotations

FLOPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}  # tensor cores; float32 outside them
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the peak, or bytes over HBM's rate, whichever is longer."""
    return max(flops / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
