"""M17 test signals: 4FSK at 4800 symbols per second, and what a block
of the test stream must decode to.

The stream (transmissions of ``encode_stream_transmission``: preamble,
LSF, stream frames, EOT, then dead air) is built by
``tools/export_torch_tables.py`` with the JAX package's M17 encoder and
stored in ``data/event_tables.npz``; here is its modulator in the form
of the JAX package's ``dibits_to_baseband`` (the instantaneous frequency
level/3 · ``dev`` · Nyquist, rectangular, phase continuous), at M17's
outer deviation of 2.4 kHz, and :func:`judge`, which holds a block's
frames and events to the stream.  A dibit of value
``protocol.dstar.encode.DEAD`` is dead air: zero I/Q.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.dstar.encode import (DEAD, POS_TOL,
                                                    match_nominal)
from dsdneo_tpu_torch.protocol.p25.encode import DIBIT_LEVELS

DEV = 0.1                   # outer deviation over Nyquist (2.4 / 24 kHz)


def fm_iq(dibits: np.ndarray, sps: int = 10, dev: float = DEV
          ) -> np.ndarray:
    """Dibit stream → complex128 baseband of ``len(dibits) · sps``
    samples; :data:`DEAD` symbols are zero."""
    d = np.asarray(dibits)
    dead = d == DEAD
    lv = DIBIT_LEVELS[np.where(dead, 0, d)] / 3.0
    x = np.exp(1j * np.pi * np.cumsum(np.repeat(lv, sps) * dev))
    x[np.repeat(dead, sps)] = 0.0
    return x


def expected_frames(tv: dict[str, np.ndarray], lead: int, n_sym: int):
    """The stream frames of the vector in a block of ``n_sym`` symbols
    after ``lead`` dibits: ({nominal sync position: index}, the indices
    of those the block must take: their 192 dibits end before it does,
    ``POS_TOL`` to spare)."""
    fr = {lead + int(s): i for i, s in enumerate(tv["fr_starts"])}
    return fr, {i for t, i in fr.items()
                if t >= POS_TOL and t + 192 < n_sym - POS_TOL}


def lsf_expected(tv: dict[str, np.ndarray], want) -> dict:
    """The LSFs a block assembles: {index of the frame with counter 5:
    transmission} for every run of six frames (counters 0-5) of one
    transmission whose indices all lie in ``want``."""
    out = {}
    for x in range(len(tv["lsf"])):
        idx = np.flatnonzero(tv["fr_tx"] == x)
        for j in range(0, len(idx) - 5, 6):
            if all(int(i) in want for i in idx[j:j + 6]):
                out[int(idx[j + 5])] = x
    return out


def judge(tv: dict[str, np.ndarray], lead: int, n_sym: int, recs,
          lines, gate: int = 3, before=frozenset()) -> set:
    """Hold one channel's picked hits ``recs`` [(position, 26-byte blob
    row)] and the block's event ``lines`` to the vector: every stream
    frame the block may take passes the LICH gate (largest Golay error ≤
    ``gate``) with the vector's FN and payload bytes, no other hit
    passes it, and the LSF assembles CRC-valid with the vector's
    callsigns and CAN exactly as often as the block completes six
    chunks (counters 0-5) of one transmission, counting the frames of
    earlier blocks in ``before`` (the context carries the chunks).
    Raises on a miss; returns the indices of the frames that passed."""
    fr, need = expected_frames(tv, lead, n_sym)
    passed = [(t, r) for t, r in recs if r[24] <= gate]
    got = match_nominal([t for t, _ in passed], fr)
    if None in got.values() or not need <= set(got.values()):
        raise RuntimeError(f"M17 lead {lead}: the frames that pass the "
                           "gate are not the vector's")
    for t, r in passed:
        i = got[t]
        if not ((int(r[0]) << 8 | int(r[1])) == tv["fr_fn"][i]
                and np.array_equal(r[2:18], tv["fr_payload"][i])):
            raise RuntimeError(f"M17 lead {lead}: frame {i} decoded "
                               "otherwise")
    lsf = [ln for ln in lines if "SRC:" in ln]
    now = set(got.values())
    want_lsf = {i: x for i, x in lsf_expected(
        tv, now | set(before)).items() if i in now}
    if len(lsf) != len(want_lsf):
        raise RuntimeError(f"M17 lead {lead}: {len(lsf)} LSFs assembled, "
                           f"{len(want_lsf)} expected")
    for ln, x in zip(lsf, want_lsf.values()):
        dst, src = (str(v) for v in tv["calls"][x])
        if f"CAN: {int(tv['can'][x])} DST: {dst} SRC: {src}" not in ln:
            raise RuntimeError(f"M17 lead {lead}: LSF line {ln!r}")
    return now
