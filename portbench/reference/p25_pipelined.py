"""Reference of the ``p25_pipelined`` entry: one block of per-channel
basebands through the plain chain (``p25_chain.P25Chain``) from the
sampled voice carry, judged by ``p25_judge``."""

from __future__ import annotations

from portbench.reference.p25_judge import P25Reference as Reference

__all__ = ["Reference"]
