"""DMR BS two-slot voice test signals.

The stream itself (dibits and the 49 parameter bits of every AMBE frame)
is the JAX package's ``engine.dmrbatch.synth_voice_stream(8, seed=1)``,
stored in the tables file by ``tools/export_torch_tables.py``; here are
its 4-level FM modulator (numpy, identical output) and what builds
many-channel blocks from it, or from another stream and modulator (the
X2-TDMA, P25p2 and NXDN vectors).  X2-TDMA shares the stream's
superframe geometry, so :func:`expected_frames` serves it too.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.engine.dmrbatch import SF_EXTENT, SF_PERIOD
from dsdneo_tpu_torch.protocol.p25.encode import DIBIT_LEVELS

FIRST_SYNC = 90 + 66            # slot 0's first voice sync in the stream


def dmr_fm_iq(dibits: np.ndarray, sps: int = 10) -> np.ndarray:
    """Dibit stream → complex64 4-level FM baseband: rectangular
    frequency pulses of ±1/±3 thirds of full deviation, their edges
    smoothed by a Gaussian of σ = sps/4 so the symbol centres keep full
    deviation, a quarter of the Nyquist swing per sample."""
    lv = DIBIT_LEVELS[np.asarray(dibits)] / 3.0
    inst = np.repeat(lv, sps)
    t = np.arange(-sps // 2, sps // 2 + 1)
    g = np.exp(-0.5 * (t / (sps / 4.0)) ** 2)
    inst = np.convolve(inst, g / g.sum(), mode="same") * 0.25
    return np.exp(1j * np.pi * np.cumsum(inst)).astype(np.complex64)


def vector_block(tv: dict[str, np.ndarray], leads, noise_seeds,
                 n_samples: int, sps: int = 10, snr_db: float = 30.0,
                 invert: bool = False, modulate=dmr_fm_iq,
                 lead_dibits: np.ndarray | None = None) -> np.ndarray:
    """``[C, n_samples, 2]`` float32 I/Q planes: channel c carries the
    test vector after ``leads[c]`` random filler dibits, with white noise
    of seed ``noise_seeds[c]`` (which also draws the filler); with
    ``lead_dibits`` the filler is its last ``leads[c]`` dibits.  ``invert``
    negates the FM (the I/Q conjugate), as a receiver with swapped I and
    Q would see the stream.  ``modulate(dibits, sps)`` gives at least
    ``len(dibits) · sps`` complex samples; the first are kept."""
    n_dib = n_samples // sps
    out = np.empty((len(leads), n_samples, 2), dtype=np.float32)
    for c, (lead, seed) in enumerate(zip(leads, noise_seeds)):
        rng = np.random.default_rng(int(seed))
        fill = (rng.integers(0, 4, int(lead)).astype(np.uint8)
                if lead_dibits is None
                else lead_dibits[len(lead_dibits) - int(lead):])
        if len(fill) != int(lead):
            raise ValueError(f"lead {lead} is longer than the filler")
        dib = np.concatenate([fill, tv["dibits"]])[:n_dib]
        if len(dib) < n_dib:
            raise ValueError(f"the vector holds {len(dib)} dibits after "
                             f"this lead, fewer than {n_dib}")
        x = modulate(dib, sps)[:n_dib * sps]
        noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
        x = x + noise * 10 ** (-snr_db / 20)
        out[c, :, 0] = x.real
        out[c, :, 1] = -x.imag if invert else x.imag
    return out


def expected_frames(tv: dict[str, np.ndarray], lead: int, n_sym: int):
    """The superframes of the vector a block of ``n_sym`` symbols holds
    whole after ``lead`` filler dibits, in stream order (the two slots
    alternate): (sync positions ``[S]``, parameter bits ``[S, 18, 49]``).
    The picker takes a superframe at sync position t only when t ≥ 54
    and t + ``SF_EXTENT`` < n_sym."""
    bits49 = tv["bits49"]                        # [2, n_sf * 18, 49]
    n_sf = bits49.shape[1] // 18
    pos, bits = [], []
    for j in range(n_sf):
        for slot in (0, 1):
            t = lead + FIRST_SYNC + SF_PERIOD * 6 * j + 144 * slot
            if t >= 54 and t + SF_EXTENT < n_sym:
                pos.append(t)
                bits.append(bits49[slot, 18 * j:18 * (j + 1)])
    return (np.asarray(pos, np.int64),
            np.stack(bits) if bits else np.zeros((0, 18, 49), np.uint8))
