"""Frame-sync definitions, hits and the host sync hunt.

The port's own copy of ``dsdneo_tpu/symbols/framesync.py``: the whole
``SYNC_DEFS`` table in its order (the batched monitors stack the rows
they name with :func:`sync_levels`), and the host functions of the
serial decode path, numpy in both packages: the normalized correlation
of every enabled pattern against a channel's soft symbols
(``correlate_syncs``), the greedy non-overlapping peak pick
(``pick_syncs_from_best``, ``pick_syncs_from_scores``, ``find_syncs``)
and the polarity twin of a DMR sync (``polarity_twin``).  The soft
stream comes to the host once.
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


# Pattern table (protocol standard constants; layout parity with the
# reference's sync_patterns.h).
SYNC_DEFS: list[SyncDef] = [
    SyncDef("+P25p1", "111113113311333313133333", "p25p1", "frame"),
    SyncDef("-P25p1", "333331331133111131311111", "p25p1", "frame", True),
    SyncDef("+P25p2", "11131131111333133333", "p25p2", "frame"),
    SyncDef("-P25p2", "33313313333111311111", "p25p2", "frame", True),
    SyncDef("+DMR BS data", "313333111331131131331131", "dmr", "bs_data"),
    SyncDef("+DMR BS voice", "131111333113313313113313", "dmr", "bs_voice"),
    SyncDef("+DMR MS data", "311131133313133331131113", "dmr", "ms_data"),
    SyncDef("+DMR MS voice", "133313311131311113313331", "dmr", "ms_voice"),
    SyncDef("+DMR MS RC", "131331111133133133311313", "dmr", "ms_rc"),
    SyncDef("+DMR DM TS1 data", "331333313111313133311111", "dmr", "dm_ts1_data"),
    SyncDef("+DMR DM TS1 voice", "113111131333131311133333", "dmr", "dm_ts1_voice"),
    SyncDef("+DMR DM TS2 data", "311311111333113333133311", "dmr", "dm_ts2_data"),
    SyncDef("+DMR DM TS2 voice", "133133333111331111311133", "dmr", "dm_ts2_voice"),
    # Inverted-polarity DMR (reference opts->inverted_dmr, args.c:2440):
    # DMR's BS voice and data syncs are dibit complements of each
    # other, so an inverted def's pattern EQUALS the opposite burst
    # type's normal pattern.  They sit AFTER the + defs so argmax ties
    # resolve to normal polarity; the serial path reinterprets hits
    # under the -xr expectation (engine/decoder.py), and the batched
    # pipeline disambiguates with its EMB gate (engine/dmrbatch.py).
    SyncDef("-DMR BS voice", "313333111331131131331131", "dmr", "bs_voice", True),
    SyncDef("-DMR BS data", "131111333113313313113313", "dmr", "bs_data", True),
    SyncDef("+NXDN BS data", "313133113131111313", "nxdn", "bs_data"),
    SyncDef("+NXDN BS voice", "313133113131113113", "nxdn", "bs_voice"),
    SyncDef("+NXDN MS data", "313133113131111333", "nxdn", "ms_data"),
    SyncDef("+NXDN MS voice", "313133113131113133", "nxdn", "ms_voice"),
    SyncDef("-NXDN BS data", "131311331313333131", "nxdn", "bs_data", True),
    SyncDef("-NXDN BS voice", "131311331313331331", "nxdn", "bs_voice", True),
    SyncDef("-NXDN MS data", "131311331313333111", "nxdn", "ms_data", True),
    SyncDef("-NXDN MS voice", "131311331313331311", "nxdn", "ms_voice", True),
    SyncDef("+NXDN FSW", "3131331131", "nxdn", "fsw"),
    SyncDef("-NXDN FSW", "1313113313", "nxdn", "fsw", True),
    SyncDef("+D-STAR", "313131313133131113313111", "dstar", "voice"),
    SyncDef("-D-STAR", "131313131311313331131333", "dstar", "voice", True),
    SyncDef("+D-STAR HD", "131313131333133113131111", "dstar", "hd"),
    SyncDef("-D-STAR HD", "313131313111311331313333", "dstar", "hd", True),
    SyncDef("+YSF", "31111311313113131131", "ysf", "frame"),
    SyncDef("-YSF", "13333133131331313313", "ysf", "frame", True),
    SyncDef("+M17 LSF", "3131313133331131", "m17", "pre_lsf"),
    SyncDef("-M17 LSF", "1313131311113313", "m17", "pre_lsf", True),
    SyncDef("+M17 STR", "33331131", "m17", "str"),
    SyncDef("-M17 STR", "11113313", "m17", "str", True),
    SyncDef("+M17 PKT", "13113333", "m17", "pkt"),
    SyncDef("-M17 PKT", "31331111", "m17", "pkt", True),
    SyncDef("+M17 BRT", "31331111", "m17", "brt"),
    SyncDef("-M17 BRT", "13113333", "m17", "brt", True),
    SyncDef("+dPMR FS1", "111333331133131131111313", "dpmr", "fs1"),
    SyncDef("+dPMR FS2", "113333131331", "dpmr", "fs2"),
    SyncDef("+dPMR FS3", "133131333311", "dpmr", "fs3"),
    SyncDef("+dPMR FS4", "333111113311313313333131", "dpmr", "fs4"),
    SyncDef("-dPMR FS2", "331111313113", "dpmr", "fs2", True),
    SyncDef("-dPMR FS3", "311313111133", "dpmr", "fs3", True),
    SyncDef("+X2-TDMA BS voice", "113131333331313331113311", "x2tdma", "bs_voice"),
    SyncDef("+X2-TDMA BS data", "331313111113131113331133", "x2tdma", "bs_data"),
    SyncDef("+X2-TDMA MS voice", "131331111333333311111131", "x2tdma", "ms_voice"),
    SyncDef("+X2-TDMA MS data", "313113333111111133333313", "x2tdma", "ms_data"),
    SyncDef("+EDACS", "313131313131313131313111333133133131313131313131", "edacs", "frame"),
    SyncDef("-EDACS", "131313131313131313131333111311311313131313131313", "edacs", "frame", True),
    SyncDef("+ProVoice", "13131333111311311133113311331133", "provoice", "frame"),
    SyncDef("-ProVoice", "31313111333133133311331133113311", "provoice", "frame", True),
    SyncDef("+ProVoice EA", "31131311331331111133131311311133", "provoice", "ea"),
    SyncDef("-ProVoice EA", "13313133113113333311313133133311", "provoice", "ea", True),
]


def patterns_for(protocols: set[str] | None) -> list[SyncDef]:
    if protocols is None:
        return SYNC_DEFS
    return [s for s in SYNC_DEFS if s.protocol in protocols]


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


def correlate_syncs(soft: np.ndarray, defs: list[SyncDef]) -> np.ndarray:
    """Normalized correlation of each pattern vs soft symbols.

    soft: ``[K]`` normalized symbols (outer level ≈ ±3).
    Returns ``[P, K]`` scores (zero-padded past valid range).
    """
    k = soft.shape[0]
    out = np.zeros((len(defs), k), dtype=np.float32)
    for i, d in enumerate(defs):
        lv = d.levels
        n = lv.shape[0]
        if k < n:
            continue
        c = np.correlate(soft, lv, mode="valid") / (9.0 * n)
        out[i, : c.shape[0]] = c
    return out


def pick_syncs_from_best(best_def: np.ndarray, best_score: np.ndarray,
                         defs: list[SyncDef], threshold: float = 0.70,
                         limit: int | None = None) -> list[SyncHit]:
    """Greedy non-overlapping peak picking over per-position
    (best pattern, best score) arrays — the shared core of the host and
    device hunters.

    Scan positions in order; at each position take the best-scoring
    pattern above threshold, refined to the local maximum within the
    next 8 positions (one short-sync length) so a marginal false hit a
    few symbols before a perfect sync cannot shadow it."""
    k = best_score.shape[0] if limit is None else min(limit,
                                                      best_score.shape[0])
    # short patterns need a stricter score to keep the false-hit rate
    # comparable to the 24-symbol syncs
    thr = np.full(len(defs), threshold, dtype=np.float32)
    for i, d in enumerate(defs):
        if len(d.pattern) <= 8:
            thr[i] = max(threshold, 0.88)
    eff_thr = thr[best_def]
    hits: list[SyncHit] = []
    # sparse scan: only threshold crossings are visited
    cands = np.flatnonzero(best_score[:k] >= eff_thr[:k])
    pos = 0
    for t in cands:
        if t < pos:
            continue
        lo, hi = int(t), min(int(t) + 8, k)
        p = lo + int(np.argmax(best_score[lo:hi]))
        d = defs[int(best_def[p])]
        hits.append(SyncHit(pos=p, score=float(best_score[p]), sync=d))
        pos = p + len(d.pattern)
    return hits


def pick_syncs_from_scores(scores: np.ndarray, defs: list[SyncDef],
                           threshold: float = 0.70,
                           limit: int | None = None) -> list[SyncHit]:
    """Greedy peak picking over precomputed ``[P, K]`` correlation
    scores (see pick_syncs_from_best)."""
    best_def = np.argmax(scores, axis=0)
    best_score = scores[best_def, np.arange(scores.shape[1])]
    return pick_syncs_from_best(best_def, best_score, defs, threshold,
                                limit)


def polarity_twin(sd: SyncDef) -> SyncDef | None:
    """The opposite-polarity def sharing ``sd``'s exact pattern, or
    None.  Exists only where a protocol's inverted sync coincides with
    another normal sync (DMR: voice⁻ ≡ data⁺), so a correlation hit is
    polarity-ambiguous and must be reinterpreted under an explicit
    expectation rather than re-correlated."""
    for d in SYNC_DEFS:
        if (d.protocol == sd.protocol and d.pattern == sd.pattern
                and d.inverted != sd.inverted):
            return d
    return None


def find_syncs(soft: np.ndarray, defs: list[SyncDef] | None = None,
               threshold: float = 0.70) -> list[SyncHit]:
    """Detect sync hits in a soft symbol stream.

    Greedy non-overlapping peak picking: scan positions in order; at each
    position take the best-scoring pattern above threshold.
    """
    defs = defs if defs is not None else SYNC_DEFS
    scores = correlate_syncs(soft, defs)
    return pick_syncs_from_scores(scores, defs, threshold,
                                  limit=soft.shape[0])
