"""D-STAR test signals: GMSK (2-level FM, BT 0.5) at 4800 symbols per
second, and what a block of the test stream must decode to.

The stream itself (a bursty run of transmissions: preamble, RF header,
voice superframes with slow data, end pattern, dead air) is built by
``tools/export_torch_tables.py`` from the JAX package's own encoders and
stored in ``data/event_tables.npz``; here is its modulator, which
``protocol.dmr.encode.vector_block`` takes as ``modulate`` to build
many-channel blocks, and :func:`judge`, which holds a block's accepted
frames to the stream.  A dibit of value :data:`DEAD` is dead air: no
carrier, zero I/Q, which the power gate of the front end zeroes.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.dstar.decoder import crc16_x25
from dsdneo_tpu_torch.protocol.p25.encode import DIBIT_LEVELS

DEAD = 4                    # dibit value of a symbol of dead air
DEV_HZ = 1200.0             # GMSK at 4800 baud: h = 0.5, ±1200 Hz
BT = 0.5                    # the Gaussian filter's bandwidth-time product
POS_TOL = 2                 # symbols a frame may sit off its nominal start
HD_SOLO_SCORE = 0.68        # the pipeline's header emit floor


def fm_iq(dibits: np.ndarray, sps: int = 10, fs: float = 48000.0,
          dev_hz: float = DEV_HZ, bt: float = BT) -> np.ndarray:
    """Dibit stream → complex128 baseband of ``len(dibits) · sps``
    samples: dibit 1 (+3) at +``dev_hz``, dibit 3 (−3) at −``dev_hz``,
    the frequency pulses shaped by a Gaussian of bandwidth-time product
    ``bt`` (σ = √ln2 / (2π·bt) symbols); :data:`DEAD` symbols are
    zero."""
    d = np.asarray(dibits)
    dead = d == DEAD
    inst = np.repeat(DIBIT_LEVELS[np.where(dead, 1, d)] / 3.0, sps) * dev_hz
    sig = np.sqrt(np.log(2.0)) / (2 * np.pi * bt) * sps
    t = np.arange(-int(4 * sig), int(4 * sig) + 1)
    g = np.exp(-0.5 * (t / sig) ** 2)
    inst = np.convolve(inst, g / g.sum(), mode="same")
    x = np.exp(1j * 2 * np.pi * np.cumsum(inst) / fs)
    x[np.repeat(dead, sps)] = 0.0
    return x


def expected_frames(tv: dict[str, np.ndarray], lead: int, n_sym: int):
    """The frames of the vector in a block of ``n_sym`` symbols after
    ``lead`` dibits, by nominal sync position (negative before the
    block): (headers {position: index}, superframes {position: index},
    the (kind, index) pairs the block must accept).  A header needs its
    684 dibits in the block; a superframe its 2016 and a partner
    superframe of its transmission whose sync lies in the block (2016
    apart).  The timing recovery may
    place a transmission that follows dead air a symbol or two off its
    nominal position (the phase of a dead-air window is the noise's), so
    a frame is found within ``POS_TOL`` of it, and one within that of
    the block end may or may not be taken."""
    hd = {lead + int(s): i for i, s in enumerate(tv["hd_starts"])}
    sf = {lead + int(s): i for i, s in enumerate(tv["sf_starts"])}
    lim = n_sym - POS_TOL
    need = {(1, i) for t, i in hd.items()
            if t >= POS_TOL and t + 684 <= lim}
    in_block = {t for t in sf if t >= POS_TOL and t + 24 <= lim}
    need |= {(0, i) for t, i in sf.items()
             if t >= POS_TOL and t + 2016 <= lim
             and (t - 2016 in in_block or t + 2016 in in_block)}
    return hd, sf, need


def match_nominal(got, want: dict) -> dict:
    """Accepted positions ``got`` → {accepted position: index of the
    nominal position of ``want`` within ``POS_TOL``}; a position
    with no nominal one maps to None."""
    keys = np.asarray(sorted(want), np.int64)
    out = {}
    for t in got:
        j = np.flatnonzero(np.abs(keys - t) <= POS_TOL) if keys.size \
            else []
        out[t] = want[int(keys[j[0]])] if len(j) else None
    return out


def junk_allowed(t: int, want: dict, extent: int, excused: set) -> bool:
    """Whether a pick at ``t`` that is no frame of ``want`` ({nominal
    position: index}) may stand: it lies inside a frame whose sync starts
    before the block's first ``POS_TOL`` symbols, or inside one that an
    earlier such pick suppressed (``excused``), where no accepted frame
    suppresses it (the JAX package's picks do the same)."""
    return any(s < t < s + extent and (s < POS_TOL or i in excused)
               for s, i in want.items())


def suppressed_by(t: int, want: dict, extent: int) -> set:
    """The frames of ``want`` that a pick at ``t`` suppresses: those
    starting less than ``extent − 8`` after it."""
    return {i for s, i in want.items() if 0 < s - t < extent - 8}


def _crc_ok(hdr: np.ndarray) -> bool:
    return crc16_x25(hdr[:39]) == (int(hdr[39]) << 8) | int(hdr[40])


def judge(tv: dict[str, np.ndarray], lead: int, n_sym: int, recs,
          hd_solo: float = HD_SOLO_SCORE) -> int:
    """Hold one channel's accepted frames ``recs`` [(position, kind,
    score, record)] to the vector: every header the block holds is
    accepted, CRC-valid, with the vector's 41 octets; every partnered
    superframe with the vector's slow-data bytes, raw AMBE bits and
    49-bit parameters and 0 ECC errors; any other accepted frame is a
    header whose CRC fails and whose score is under ``hd_solo`` (it
    emits nothing).  Raises on a miss; returns the frames checked."""
    hd, sf, need = expected_frames(tv, lead, n_sym)
    seen = set()
    for t, k, score, r in recs:
        i = match_nominal([t], hd if k else sf)[t]
        if i is None:
            if not (k == 1 and not _crc_ok(r) and score < hd_solo):
                raise RuntimeError(f"D-STAR lead {lead}: a frame of kind "
                                   f"{k} at {t} is not the vector's")
            continue
        seen.add((k, i))
        if k == 1:
            ok = np.array_equal(r, tv["hd_octets"][i]) and _crc_ok(r)
        else:
            ambe = np.unpackbits(r[249:396]).reshape(21, 56)[:, :49]
            ok = (np.array_equal(r[:60], tv["sf_sd"][i])
                  and np.array_equal(np.unpackbits(r[60:249]).reshape(
                      21, 72), tv["sf_voice"][i])
                  and np.array_equal(ambe, tv["sf_bits49"][i])
                  and not r[396:].any())
        if not ok:
            raise RuntimeError(f"D-STAR lead {lead}: {'header' if k else
                               'superframe'} {i} decoded otherwise")
    if not need <= seen:
        raise RuntimeError(f"D-STAR lead {lead}: missed "
                           f"{sorted(need - seen)[:6]}")
    return len(seen)
