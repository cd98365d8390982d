"""C4FM test signals for the P25p1 voice path.

Counterpart of ``c4fm_iq`` in ``dsdneo_tpu/protocol/p25/encode.py``
(numpy, identical output), plus what builds many-channel blocks from
the test vector that ``tools/export_torch_tables.py`` stores in the
tables file: 16 LDUs of synthesized voice between random lead and tail
filler, with the 88 IMBE parameter bits of every frame.
"""

from __future__ import annotations

import numpy as np


def c4fm_iq(dibits: np.ndarray, sps: int = 10, fs: float = 48000.0,
            dev_hz: float = 1800.0, snr_db: float = 30.0,
            seed: int = 0) -> np.ndarray:
    """Dibit stream → complex64 C4FM-style baseband with white noise."""
    lv = np.array([1.0, 3.0, -1.0, -3.0])[np.asarray(dibits)]
    inst = np.repeat(lv, sps) * (dev_hz / 3.0)
    k = max(sps // 2, 1)
    inst = np.convolve(inst, np.ones(k) / k, mode="same")
    phase = 2 * np.pi * np.cumsum(inst) / fs
    x = np.exp(1j * phase)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
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
                 n_samples: int, sps: int = 10) -> np.ndarray:
    """``[C, n_samples, 2]`` float32 I/Q planes: channel c carries the
    test vector after ``leads[c]`` filler dibits, with noise seed
    ``noise_seeds[c]``."""
    n_dib = n_samples // sps
    out = np.empty((len(leads), n_samples, 2), dtype=np.float32)
    for c, (lead, seed) in enumerate(zip(leads, noise_seeds)):
        x = c4fm_iq(vector_stream(tv, int(lead), n_dib), sps=sps,
                    seed=int(seed))
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
