"""Frame-sync definitions and hits (host).

The port's own copy of ``SyncDef``, ``SyncHit`` and the rows of
``SYNC_DEFS`` in ``dsdneo_tpu/symbols/framesync.py`` that its monitors
name (P25 Phase 1 and Phase 2, DMR BS data and voice, NXDN FSW, D-STAR
voice and header, YSF, M17 stream, dPMR FS2, EDACS), in that table's
order.  A catalog reads a hit's position and its definition's name.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyncDef:
    name: str
    pattern: str          # DSD dibit alphabet: '1' = +3, '3' = -3
    protocol: str         # protocol family key
    kind: str             # e.g. "voice", "data", "cc", "hd" ...
    inverted: bool = False

    @property
    def levels(self) -> np.ndarray:
        return np.array([3.0 if ch == "1" else -3.0 for ch in self.pattern],
                        dtype=np.float32)


SYNC_DEFS: list[SyncDef] = [
    SyncDef("+P25p1", "111113113311333313133333", "p25p1", "frame"),
    SyncDef("-P25p1", "333331331133111131311111", "p25p1", "frame", True),
    SyncDef("+P25p2", "11131131111333133333", "p25p2", "frame"),
    SyncDef("-P25p2", "33313313333111311111", "p25p2", "frame", True),
    SyncDef("+DMR BS data", "313333111331131131331131", "dmr", "bs_data"),
    SyncDef("+DMR BS voice", "131111333113313313113313", "dmr", "bs_voice"),
    SyncDef("-DMR BS voice", "313333111331131131331131", "dmr", "bs_voice", True),
    SyncDef("-DMR BS data", "131111333113313313113313", "dmr", "bs_data", True),
    SyncDef("+NXDN FSW", "3131331131", "nxdn", "fsw"),
    SyncDef("-NXDN FSW", "1313113313", "nxdn", "fsw", True),
    SyncDef("+D-STAR", "313131313133131113313111", "dstar", "voice"),
    SyncDef("+D-STAR HD", "131313131333133113131111", "dstar", "hd"),
    SyncDef("+YSF", "31111311313113131131", "ysf", "frame"),
    SyncDef("+M17 STR", "33331131", "m17", "str"),
    SyncDef("+dPMR FS2", "113333131331", "dpmr", "fs2"),
    SyncDef("-dPMR FS2", "331111313113", "dpmr", "fs2", True),
    SyncDef("+EDACS", "313131313131313131313111333133133131313131313131",
            "edacs", "frame"),
    SyncDef("-EDACS", "131313131313131313131333111311311313131313131313",
            "edacs", "frame", True),
]


def sync_levels(names) -> np.ndarray:
    """``[P, n]`` float32 levels of the named definitions (all of one
    length), in the table's order, as the JAX package's
    ``_sync_kernel`` stacks them."""
    return np.stack([d.levels for d in SYNC_DEFS if d.name in names])


@dataclass
class SyncHit:
    pos: int              # index of the first sync symbol
    score: float          # normalized correlation in [-1, 1]
    sync: SyncDef

    @property
    def end(self) -> int:
        return self.pos + len(self.sync.pattern)
