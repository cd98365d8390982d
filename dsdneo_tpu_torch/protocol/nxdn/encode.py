"""NXDN voice test signals.

The stream (192-dibit full-voice frames and the 49 parameter bits of
each AMBE frame) is built by ``tools/export_torch_tables.py`` from the
JAX package's NXDN tables and stored in ``data/tdma_tables.npz``; here
is its modulator, the form of the JAX package's test signal
(``tests/test_dsp.synth_c4fm``): four-level FM of ±``dev_hz`` at the
outer levels, a moving average over half a symbol, and a fractional
sample delay, in numpy.  ``protocol.dmr.encode.vector_block`` builds
many-channel blocks with it.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean

NXDN48_DEV_HZ = 1050.0
NXDN96_DEV_HZ = 2400.0


def nxdn_fm_iq(dibits: np.ndarray, sps: int = 20, fs: float = 48000.0,
               dev_hz: float = NXDN48_DEV_HZ,
               frac_offset: float = 0.3) -> np.ndarray:
    """Dibit stream → ``len(dibits)·sps − 1`` complex128 samples, delayed
    by ``frac_offset`` of a sample (linear interpolation)."""
    x = c4fm_clean(dibits, sps, fs, dev_hz)
    return x[:-1] * (1 - frac_offset) + x[1:] * frac_offset


def modulator(mode: str):
    """``modulate(dibits, sps)`` for ``vector_block``: one more dibit
    than asked is modulated, so the block gets its full length."""
    dev = NXDN48_DEV_HZ if mode == "nxdn48" else NXDN96_DEV_HZ
    return lambda d, sps: nxdn_fm_iq(np.append(d, 0), sps, dev_hz=dev)
