"""``adpcm_enc_roofline_pct.dmr``: kernel K3's share of its roofline at
the DMR cell's shapes (both slots' PCM, 160 samples a padded step of
every channel), read as ``adpcm_enc_roofline_pct`` reads it."""

from portbench.layers.adpcm_enc_roofline_pct import read

__all__ = ["read"]
