"""C4FM and CQPSK test signals for the P25p1 voice path.

Counterpart of ``c4fm_iq`` in ``dsdneo_tpu/protocol/p25/encode.py``
(numpy, identical output); a π/4-DQPSK modulator (:func:`cqpsk_iq`, the
form the JAX package's CQPSK tests synthesize their input in, with the
C4FM dibit levels); and what builds many-channel blocks from
the test vector that ``tools/export_torch_tables.py`` stores in the
tables file: 16 LDUs of synthesized voice between random lead and tail
filler, with the 88 IMBE parameter bits of every frame.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.dsp import firdes

DIBIT_LEVELS = np.array([1.0, 3.0, -1.0, -3.0])


def c4fm_clean(dibits: np.ndarray, sps: int = 10, fs: float = 48000.0,
               dev_hz: float = 1800.0) -> np.ndarray:
    """Dibit stream → complex128 C4FM-style baseband: levels ±1/±3 of
    ``dev_hz / 3`` Hz, shaped by a moving average over half a symbol.
    With ``fs = 8 · 6000`` it is the modulator of the JAX package's
    X2-TDMA and P25p2 stream generators (``x2batch.py:78-85``,
    ``p2batch.py:172-178``)."""
    lv = DIBIT_LEVELS[np.asarray(dibits)]
    inst = np.repeat(lv, sps) * (dev_hz / 3.0)
    k = max(sps // 2, 1)
    inst = np.convolve(inst, np.ones(k) / k, mode="same")
    return np.exp(1j * (2 * np.pi * np.cumsum(inst) / fs))


def tdma_fm_iq(dibits: np.ndarray, sps: int = 8) -> np.ndarray:
    """The X2-TDMA and P25p2 streams' modulator (6000 symbols/s at
    ``sps · 6000`` Hz), as ``modulate`` of
    ``protocol.dmr.encode.vector_block``."""
    return c4fm_clean(dibits, sps, fs=sps * 6000.0)


def c4fm_iq(dibits: np.ndarray, sps: int = 10, fs: float = 48000.0,
            dev_hz: float = 1800.0, snr_db: float = 30.0,
            seed: int = 0) -> np.ndarray:
    """Dibit stream → complex64 C4FM-style baseband with white noise."""
    x = c4fm_clean(dibits, sps, fs, dev_hz)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * 10 ** (-snr_db / 20)).astype(np.complex64)


def cqpsk_iq(dibits: np.ndarray, sps: int = 10, fs: float = 48000.0,
             cfo_hz: float = 0.0, snr_db: float = 30.0,
             seed: int = 0) -> np.ndarray:
    """Dibit stream → complex64 π/4-DQPSK baseband of ``len(dibits)·sps``
    samples: a phase step of level·π/4 per symbol (level ±1/±3 as in
    C4FM), one impulse per symbol at its centre, root-raised-cosine
    shaping (α 0.2, 8 symbols) scaled to unit mean power, a carrier
    offset of ``cfo_hz`` and white noise."""
    lv = DIBIT_LEVELS[np.asarray(dibits)]
    n = len(lv) * sps
    x = np.zeros(n, np.complex128)
    x[np.arange(len(lv)) * sps + sps // 2] = np.exp(
        1j * np.cumsum(lv * (np.pi / 4.0)))
    x = np.convolve(x, firdes.rrc(sps, 8 * sps | 1, 0.2), mode="same")
    x = x * (np.exp(2j * np.pi * cfo_hz * np.arange(n) / fs)
             / np.sqrt(np.mean(np.abs(x) ** 2)))
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=n) + 1j * rng.normal(size=n)
    return (x + noise * 10 ** (-snr_db / 20)).astype(np.complex64)


def vector_stream(tv: dict[str, np.ndarray], lead: int,
                  n_dibits: int) -> np.ndarray:
    """One channel's dibits: the last ``lead`` filler dibits, the 16
    LDUs of the test vector and its tail filler, cut to ``n_dibits``."""
    if not 0 <= lead <= len(tv["lead"]):
        raise ValueError(f"lead must be in [0, {len(tv['lead'])}]")
    s = np.concatenate([tv["lead"][len(tv["lead"]) - lead:], tv["body"],
                        tv["tail"]])
    if len(s) < n_dibits:
        raise ValueError(f"the vector holds {len(s)} dibits after this "
                         f"lead, fewer than {n_dibits}")
    return s[:n_dibits]


def vector_block(tv: dict[str, np.ndarray], leads, noise_seeds,
                 n_samples: int, sps: int = 10, modulation: str = "c4fm",
                 cfo_hz=None) -> np.ndarray:
    """``[C, n_samples, 2]`` float32 I/Q planes: channel c carries the
    test vector after ``leads[c]`` filler dibits, with noise seed
    ``noise_seeds[c]``, as C4FM or (``modulation="cqpsk"``) as
    π/4-DQPSK with carrier offset ``cfo_hz[c]``."""
    if modulation not in ("c4fm", "cqpsk"):
        raise ValueError(f"unknown modulation {modulation!r}")
    n_dib = n_samples // sps
    out = np.empty((len(leads), n_samples, 2), dtype=np.float32)
    for c, (lead, seed) in enumerate(zip(leads, noise_seeds)):
        dib = vector_stream(tv, int(lead), n_dib)
        if modulation == "c4fm":
            x = c4fm_iq(dib, sps=sps, seed=int(seed))
        else:
            x = cqpsk_iq(dib, sps=sps, seed=int(seed),
                         cfo_hz=0.0 if cfo_hz is None else float(cfo_hz[c]))
        out[c, :, 0] = x.real
        out[c, :, 1] = x.imag
    return out


def expected_ldus(tv: dict[str, np.ndarray], lead: int,
                  n_sym: int) -> int:
    """How many of the vector's LDUs a block of ``n_sym`` symbols holds
    whole after ``lead`` filler dibits (the picker accepts an LDU at
    sync position p only when p plus the LDU's length is < n_sym)."""
    starts = tv["ldu_starts"]
    ldu_len = int(starts[1] - starts[0])
    return int(np.sum(lead + starts + ldu_len < n_sym))
