"""``fir_disc_roofline_pct.dmr``: kernel K1's share of its roofline at
the DMR cell's shapes (the entry's ``kernel_shapes``), read as
``fir_disc_roofline_pct`` reads it."""

from portbench.layers.fir_disc_roofline_pct import read

__all__ = ["read"]
