"""The demodulation modes of the ported TDMA, NXDN, D-STAR, M17, YSF,
dPMR and EDACS paths.

The port's own copy of the rows of ``dsdneo_tpu/engine/modes.py``
(``MODES``) that its pipelines use: the channel-filter profile (the name
of its taps in ``data/tdma_tables.npz``, or the ``dsp.firdes.channel_lpf``
profile the gated front end designs), the symbol rate and whether the
mode slices four levels.
"""

from __future__ import annotations

from typing import NamedTuple


class ModeConfig(NamedTuple):
    name: str
    lpf_profile: str
    symbol_rate: int
    four_level: bool


MODES: dict[str, ModeConfig] = {m.name: m for m in [
    ModeConfig("p25p2", "p25_c4fm", 6000, True),
    ModeConfig("nxdn48", "6k25", 2400, True),
    ModeConfig("nxdn96", "12k5", 4800, True),
    ModeConfig("dpmr", "6k25", 2400, True),
    ModeConfig("x2tdma", "12k5", 6000, True),
    ModeConfig("dstar", "6k25", 4800, False),
    ModeConfig("ysf", "12k5", 4800, True),
    ModeConfig("edacs", "provoice", 9600, False),
    ModeConfig("m17", "12k5", 4800, True),
]}
