"""dPMR test signals: 4-level FSK at 2400 symbols per second, and what a
block of the test stream must decode to.

The stream (bursty transmissions: an alternating preamble, then FS2
superframe parts of the ``+dPMR FS2`` sync, random control dibits and
two groups of four AMBE frames through ``encode_ambe_ecc`` at the
pipeline's voice offsets, an alternating postamble, then dead air) is
built by ``tools/export_torch_tables.py`` and stored in
``data/burst_tables.npz``; here is its modulator and :func:`judge`,
which holds a block's accepted parts to the stream.  An inverted channel (the I/Q conjugate) matches
the ``-dPMR FS2`` pattern.  A dibit of value
``protocol.dstar.encode.DEAD`` is dead air: zero I/Q.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.dstar.encode import (POS_TOL, junk_allowed,
                                                    match_nominal,
                                                    suppressed_by)
from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode

PART_DIBITS = 384
DEV = 1050.0 / 24000.0      # outer deviation over Nyquist (±1050 Hz)


def fm_iq(dibits: np.ndarray, sps: int = 20) -> np.ndarray:
    """Dibit stream → complex128 baseband of ``len(dibits) · sps``
    samples (rectangular 4-level FSK, ±1050 Hz outer deviation at 48 kHz
    and 20 samples a symbol); dead air is zero."""
    return m17_encode.fm_iq(dibits, sps, DEV)


def expected_parts(tv: dict[str, np.ndarray], lead: int, n_sym: int):
    """The parts of the vector in a block of ``n_sym`` symbols after
    ``lead`` dibits: ({nominal sync position: index}, the indices of
    those the block must take: their 384 dibits end before it does,
    ``POS_TOL`` to spare)."""
    fr = {lead + int(s): i for i, s in enumerate(tv["starts"])}
    return fr, {i for t, i in fr.items()
                if t >= POS_TOL and t + PART_DIBITS < n_sym - POS_TOL}


def judge(tv: dict[str, np.ndarray], lead: int, n_sym: int, recs,
          inverted: bool = False) -> int:
    """Hold one channel's accepted parts ``recs`` [(position, inverted
    flag, ``[8, 49]`` bits, ``[8]`` ECC error counts)] to the vector:
    every part the block holds is accepted with the channel's polarity,
    the vector's eight AMBE frames and no ECC error, and nothing else is
    accepted but a false hit inside a part whose sync lies before the
    block: no accepted part suppresses it there, and it suppresses the
    part after it, in which a false hit may stand in turn (the JAX
    package's pick does the same; ROADMAP queue 3); such parts are not
    required.  Raises on a miss; returns the parts checked."""
    fr, need = expected_parts(tv, lead, n_sym)
    got = match_nominal([t for t, *_ in recs], fr)
    seen, excused = set(), set()
    for t, inv, bits, errs in recs:
        i = got[t]
        if i is None and junk_allowed(t, fr, PART_DIBITS, excused):
            excused |= suppressed_by(t, fr, PART_DIBITS)
            continue
        if i is None:
            raise RuntimeError(f"dPMR lead {lead}: the pick at {t} is not "
                               "a part of the vector")
        if not (bool(inv) == inverted
                and np.array_equal(bits, tv["bits49"][i])
                and not np.asarray(errs).any()):
            raise RuntimeError(f"dPMR lead {lead}: part {i} decoded "
                               "otherwise")
        seen.add(i)
    if not need - excused <= seen:
        raise RuntimeError(f"dPMR lead {lead}: missed "
                           f"{sorted(need - excused - seen)[:6]}")
    return len(seen)
