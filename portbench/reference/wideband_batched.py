"""Reference of the ``wideband_batched`` entry: the band through the
plain channelizer (``band_chain``), then every bin through the plain
chain from the sampled voice carry, judged by ``p25_judge``."""

from __future__ import annotations

from portbench.reference import band_chain
from portbench.reference.p25_judge import P25Reference


class Reference(P25Reference):
    def basebands(self, block):
        return band_chain.channelize_band(block, self.cfg["channels"],
                                          self.chain)
