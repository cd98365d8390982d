"""``fir_disc_roofline_pct``: kernel K1 ``fir_disc``'s least time at the
cell's shapes over its device time a launch in the profiled span.

The counts are functions of the shapes alone, copied from
``chip_smoke.py``'s ``check_k1`` at commit
1acf1f855b4962341c6932295300c03c25b32489: each input byte read once,
each output byte written once, whatever implements the kernel."""

from portbench import roofline


def counts(C: int, B: int, ntaps: int) -> tuple[int, int]:
    """The ``[C, B, 2]`` float32 I/Q read, the ``[C, B]`` float32
    discriminator written, the taps read; per sample two planes of
    ``ntaps`` multiply-adds and 6 FLOP for the conjugate product and its
    angle's inputs → (bytes, FLOP)."""
    return C * B * 2 * 4 + C * B * 4 + ntaps * 4, C * B * (4 * ntaps + 6)


def read(ctx):
    shape = ctx.kernel_shapes.get("fir_disc")
    s, n = ctx.span.kernel("fir_disc_kernel") if ctx.span else (0.0, 0)
    if not n or not shape:
        return None
    return roofline.share_pct(*counts(*shape), s / n)
