"""Reference of the ``dmr_pipelined`` entry: one block of per-channel
basebands through the plain chain (``dmr_chain.DmrChain``) from the
sampled voice carry, judged by ``dmr_judge``."""

from __future__ import annotations

from portbench.reference.dmr_judge import DmrReference as Reference

__all__ = ["Reference"]
