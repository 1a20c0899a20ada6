"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W limit), and the roofline bound.

`bound_s` is copied from `chip_smoke.py: _bound` (the larger of the
operation time and the byte time at these peaks), in seconds.
"""

from __future__ import annotations

PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> tuple:
    """(least seconds the chip could take, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
