"""YSF test signals: 4-level FSK at 4800 symbols per second, and what a
block of the test stream must decode to.

The stream (bursty transmissions: an alternating preamble, then V/D2
frames of the ``+YSF`` sync, a FICH field of random dibits and five
voice blocks of AMBE frames put through the inverse of the pipeline's
V/D2 gather, with some data frames among them whose voice blocks are
random, an alternating postamble, then dead air) is built by
``tools/export_torch_tables.py`` and stored in ``data/burst_tables.npz``;
here is its modulator and :func:`judge`, which holds a block's accepted
frames to the stream.  A dibit of value ``protocol.dstar.encode.DEAD`` is dead air: zero I/Q.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.dstar.encode import (POS_TOL, junk_allowed,
                                                    match_nominal,
                                                    suppressed_by)
from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode

FRAME_DIBITS = 480
VOTE_ERR_MAX = 5
DEV = 0.1                   # outer deviation over Nyquist (2.4 / 24 kHz)


def fm_iq(dibits: np.ndarray, sps: int = 10) -> np.ndarray:
    """Dibit stream → complex128 baseband of ``len(dibits) · sps``
    samples (rectangular 4-level FSK, ±2.4 kHz outer deviation at 48 kHz
    and 10 samples a symbol); dead air is zero."""
    return m17_encode.fm_iq(dibits, sps, DEV)


def expected_frames(tv: dict[str, np.ndarray], lead: int, n_sym: int):
    """The frames of the vector in a block of ``n_sym`` symbols after
    ``lead`` dibits: ({nominal sync position: index}, the indices of
    those the block must take: their 480 dibits end before it does,
    ``POS_TOL`` to spare)."""
    fr = {lead + int(s): i for i, s in enumerate(tv["starts"])}
    return fr, {i for t, i in fr.items()
                if t >= POS_TOL and t + FRAME_DIBITS < n_sym - POS_TOL}


def judge(tv: dict[str, np.ndarray], lead: int, n_sym: int, recs) -> int:
    """Hold one channel's accepted frames ``recs`` [(position, ``[5, 49]``
    voted bits, ``[5]`` vote disagreements)] to the vector: every frame
    the block holds is accepted; a voice frame carries the vector's five
    AMBE frames with unanimous votes; a data frame and any other pick
    fail the vote gate (more than ``VOTE_ERR_MAX`` disagreements) on all
    five.  A false hit inside a frame whose sync lies before the block
    suppresses the frame after it, in which a false hit may stand in
    turn (the JAX package's pick does the same; ROADMAP queue 3); such
    frames are not required.  Raises on a miss; returns the voice frames
    checked."""
    fr, need = expected_frames(tv, lead, n_sym)
    got = match_nominal([t for t, _b, _e in recs], fr)
    seen, excused, n_voice = set(), set(), 0
    for t, bits, errs in recs:
        i = got[t]
        if i is not None:
            seen.add(i)
        elif junk_allowed(t, fr, FRAME_DIBITS, excused):
            excused |= suppressed_by(t, fr, FRAME_DIBITS)
        if i is not None and tv["voice"][i]:
            if not (np.array_equal(bits, tv["bits49"][i])
                    and not np.asarray(errs).any()):
                raise RuntimeError(f"YSF lead {lead}: voice frame {i} "
                                   "decoded otherwise")
            n_voice += 1
        elif not (np.asarray(errs) > VOTE_ERR_MAX).all():
            raise RuntimeError(f"YSF lead {lead}: the pick at {t} (frame "
                               f"{i}) passes the vote gate")
    if not need - excused <= seen:
        raise RuntimeError(f"YSF lead {lead}: missed "
                           f"{sorted(need - excused - seen)[:6]}")
    return n_voice
