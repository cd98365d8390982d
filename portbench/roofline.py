"""Peaks of one NVIDIA H100 SXM, and a kernel's share of its roofline.
Each kernel's bytes and operations are counted, from the cell's shapes
alone, in its metric's reader (``portbench/layers/<kernel>_roofline_pct.py``).
"""

from __future__ import annotations

HBM_BPS = 3.35e12            # bytes/s, NVIDIA's data sheet, SXM, 700 W
FP32_FLOPS = 67e12           # FLOP/s in float32 outside the tensor cores


def bound_s(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take and what sets it."""
    t_mem, t_ops = n_bytes / HBM_BPS, flops / FP32_FLOPS
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def share_pct(n_bytes: float, flops: float, seconds: float) -> float | None:
    """The roofline's least time over the measured time, in percent;
    None where nothing was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s(n_bytes, flops)[0] / seconds
