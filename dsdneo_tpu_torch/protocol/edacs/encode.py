"""EDACS control-channel test signals: 2-level FSK at 9600 symbols per
second, and what a block of the test stream must decode to.

The stream (a continuous control channel: frames of the ``+EDACS`` sync
and two BCH(40,28) words sent three times each, the middle copy
complemented; standard and extended-addressing messages) is built by
``tools/export_torch_tables.py`` and stored in ``data/burst_tables.npz``
with the JAX catalogs' event lines of every frame read three ways
(:data:`MODES`: the standard catalog, the EA catalog, and the standard
catalog after the stream's ESK mask).  Here are its modulator and
:func:`judge`, which holds a channel's accepted frames and event lines
of one block to the stream.  An inverted channel (the I/Q conjugate)
complements every word; the monitor reads it as ``-EDACS``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.dstar.encode import (POS_TOL, junk_allowed,
                                                    match_nominal,
                                                    suppressed_by)
from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode

SYNC_DIBITS = 48
FRAME_DIBITS = 48 + 240
DEV = 0.2                   # deviation over Nyquist (±4.8 kHz at 48 kHz)
MODES = ("standard", "ea", "esk")


def fm_iq(dibits: np.ndarray, sps: int = 5) -> np.ndarray:
    """Dibit stream → complex128 baseband of ``len(dibits) · sps``
    samples (rectangular 2-level FSK: dibit 1 at +4.8 kHz, dibit 3 at
    −4.8 kHz, at 48 kHz and 5 samples a symbol)."""
    return m17_encode.fm_iq(dibits, sps, DEV)


def expected_frames(tv: dict[str, np.ndarray], lead: int, n_sym: int):
    """The frames of the vector in a block of ``n_sym`` symbols after
    ``lead`` dibits: ({nominal message start: index}, the indices of
    those the block must take: the sync starts in the block and the
    message ends before it does, ``POS_TOL`` to spare)."""
    fr = {lead + int(s) + SYNC_DIBITS: i for i, s in enumerate(tv["starts"])}
    return fr, {i for t, i in fr.items()
                if t - SYNC_DIBITS >= POS_TOL
                and t + 240 < n_sym - POS_TOL}


def frame_lines(tv: dict[str, np.ndarray], i: int, mode: str,
                inverted: bool = False) -> list[str]:
    """The event lines the monitor emits for frame ``i`` read in
    ``mode``, on a channel of the given polarity."""
    sel = (tv["line_frame"] == i) & (tv["line_mode"] == MODES.index(mode))
    lines = [str(s) for s in tv["lines"][sel]]
    if inverted:
        lines = [s.replace("Sync: +EDACS", "Sync: -EDACS", 1) for s in lines]
    return lines


def judge(tv: dict[str, np.ndarray], lead: int, n_sym: int, recs, lines,
          mode: str = "standard", inverted: bool = False) -> int:
    """Hold one channel's accepted frames ``recs`` [(message start,
    12-byte blob row)] and the block's event ``lines`` to the vector:
    every frame the block holds is accepted, passes the BCH screen with
    the channel's polarity and the vector's two messages, and the lines
    are the JAX catalog's for those frames in ``mode``.  Nothing else is
    accepted but a false hit inside a frame whose sync lies before the
    block, which must fail the screen: no accepted frame suppresses it
    there, and it suppresses the frame after it (the JAX package's pick
    does the same; ROADMAP queue 3), which is then not required.  Raises
    on a miss; returns the frames checked."""
    fr, need = expected_frames(tv, lead, n_sym)
    syncs = {t - SYNC_DIBITS: i for t, i in fr.items()}
    got = match_nominal([t for t, _r in recs], fr)
    seen, excused, want_lines = set(), set(), []
    for t, r in recs:
        i = got[t]
        if i is None and not r[8] and junk_allowed(
                t - SYNC_DIBITS, syncs, FRAME_DIBITS, excused):
            want_lines.append("Sync: +EDACS  BCH FAIL")
            excused |= suppressed_by(t - SYNC_DIBITS, syncs, FRAME_DIBITS)
            continue
        if i is None:
            raise RuntimeError(f"EDACS lead {lead}: the pick at {t} is not "
                               "a frame of the vector")
        v1 = int(np.ascontiguousarray(r[0:4]).view("<u4")[0])
        v2 = int(np.ascontiguousarray(r[4:8]).view("<u4")[0])
        if not (r[8] == 1 and bool(r[9]) == inverted
                and v1 == int(tv["msg1"][i]) and v2 == int(tv["msg2"][i])):
            raise RuntimeError(f"EDACS lead {lead}: frame {i} decoded "
                               "otherwise")
        seen.add(i)
        want_lines += frame_lines(tv, i, mode, inverted)
    if not need - excused <= seen:
        raise RuntimeError(f"EDACS lead {lead}: missed "
                           f"{sorted(need - excused - seen)[:6]}")
    if list(lines) != want_lines:
        raise RuntimeError(f"EDACS lead {lead}: the {mode} lines differ "
                           "from the JAX catalog's")
    return len(seen)
