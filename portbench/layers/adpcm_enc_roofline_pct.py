"""``adpcm_enc_roofline_pct``: kernel K3 ``adpcm_enc``'s least time at
the cell's shapes over its device time a launch in the profiled span.

The counts are functions of the shapes alone, copied from
``chip_smoke.py``'s ``check_k3`` at commit
1acf1f855b4962341c6932295300c03c25b32489."""

from portbench import roofline


def counts(S: int, T: int) -> tuple[int, int]:
    """``[S, T]`` float32 read, ``[S, T/2]`` uint8 written; no
    floating-point work is counted → (bytes, FLOP)."""
    return S * T * 4 + S * (T // 2), 0


def read(ctx):
    shape = ctx.kernel_shapes.get("adpcm_enc")
    s, n = ctx.span.kernel("adpcm_enc_kernel") if ctx.span else (0.0, 0)
    if not n or not shape or not shape[1]:
        return None
    return roofline.share_pct(*counts(*shape), s / n)
