"""C4FM and CQPSK test signals for the P25p1 voice path, and the P25
Phase 2 TDMA control-channel stream.

Counterpart of ``c4fm_iq`` in ``dsdneo_tpu/protocol/p25/encode.py``
(numpy, identical output); a π/4-DQPSK modulator (:func:`cqpsk_iq`, the
form the JAX package's CQPSK tests synthesize their input in, with the
C4FM dibit levels); what builds many-channel blocks from the test
vector that ``tools/export_torch_tables.py`` stores in the tables file:
16 LDUs of synthesized voice between random lead and tail filler, with
the 88 IMBE parameter bits of every frame; and the port's own copy of
the JAX package's Phase 2 control-channel generator
(``p2_mac_payload`` .. ``p2_cc_superframes``) with its modulator
(:func:`p2_cc_iq`, that of ``tests/test_p2ccbatch.py``).
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.protocol.p25 import p2_xcch
from dsdneo_tpu_torch.protocol.p25.phase2 import DUID_CANONICAL, DUID_OFFSETS
from dsdneo_tpu_torch.symbols.framesync import SYNC_DEFS

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


# -- P25 Phase 2 TDMA control channel ----------------------------------------
def p2_mac_payload(header: int, messages: list[list[int]],
                   kind: str = "sacch") -> np.ndarray:
    """MAC PDU payload bits for one xCCH burst: 3-bit header opcode in
    octet 0, message octets from octet 1, CRC12 (inverted) in the last
    12 bits (decode side: phase2._mac_pdu + p2_mac.P2MacWalker;
    reference p25p2_xcch.c process_SACCH_MAC_PDU)."""
    nbits = 180 if kind == "sacch" else 156
    octs = [(header & 7) << 5]
    for msg in messages:
        octs.extend(int(b) & 0xFF for b in msg)
    n_oct = nbits // 8
    if len(octs) > n_oct:
        raise ValueError(f"{len(octs)} octets exceed the {kind} payload")
    payload = np.zeros(nbits, dtype=np.uint8)
    for i, o in enumerate(octs):
        for j in range(8):
            payload[8 * i + j] = (o >> (7 - j)) & 1
    nd = nbits - 12
    crc = p2_xcch.crc12_of(payload, nd)
    for j in range(12):
        payload[nd + j] = (crc >> (11 - j)) & 1
    return payload


def p2_mac_net_sts(wacn: int, sysid: int, chan16: int = 0x2114,
                   lra: int = 0) -> list[int]:
    """Network Status Broadcast MAC message (op 0x7B, bridged to the
    P1 0x3B parser which learns WACN/SYS for the P2 scrambler)."""
    return [0x7B, lra & 0xFF,
            (wacn >> 12) & 0xFF, (wacn >> 4) & 0xFF,
            ((wacn & 0xF) << 4) | ((sysid >> 8) & 0xF), sysid & 0xFF,
            (chan16 >> 8) & 0xFF, chan16 & 0xFF, 0, 0, 0]


def p2_mac_iden_up_tdma(iden: int, base_hz: float, spacing_hz: float,
                        chan_type: int = 3) -> list[int]:
    """Identifier Update TDMA MAC message (op 0x73 → P1 0x33 parser)."""
    base = int(round(base_hz / 5.0))
    spac = int(round(spacing_hz / 125.0)) & 0x3FF
    # the argument octets of the TSBK form (opcode 0x33), offset 0
    return [0x73, ((iden & 0xF) << 4) | (chan_type & 0xF), 0x80,
            (spac >> 8) & 3, spac & 0xFF, (base >> 24) & 0xFF,
            (base >> 16) & 0xFF, (base >> 8) & 0xFF, base & 0xFF]


def p2_mac_group_grant(chan16: int, tg: int, src: int,
                       svc: int = 0) -> list[int]:
    """Group Voice Channel Grant (abbreviated) MAC message (op 0x40;
    decode side p2_mac._h_grp_grant)."""
    return [0x40, svc & 0xFF, (chan16 >> 8) & 0xFF, chan16 & 0xFF,
            (tg >> 8) & 0xFF, tg & 0xFF,
            (src >> 16) & 0xFF, (src >> 8) & 0xFF, src & 0xFF]


def p2_xcch_ts(payload: np.ndarray, duid_idx: int, sf_pos: int,
               scramble: np.ndarray | None = None,
               isch_first: bool = False) -> np.ndarray:
    """One 360-bit xCCH timeslot: RS(63,35) encode, bit-geometry
    insertion, LFSR scramble at the superframe position, DUID codeword
    and ISCH word (reference p25p2_frame.c TX geometry inverted)."""
    kind = "sacch" if len(payload) == 180 else "facch"
    parity = p2_xcch.xcch_rs_encode(payload, kind)
    ts = np.zeros(360, dtype=np.uint8)
    if kind == "sacch":
        p2_xcch.insert_sacch(ts, payload, parity)
        keep = np.zeros(360, dtype=bool)
        keep[2:74] = keep[76:184] = keep[184:244] = keep[246:318] = True
    else:
        p2_xcch.insert_facch(ts, payload, parity)
        keep = np.zeros(360, dtype=bool)
        keep[2:74] = keep[76:138] = keep[180:202] = True
        keep[202:244] = keep[246:318] = True
    if scramble is not None:
        base = 360 * sf_pos + 20
        ts = np.where(keep, ts ^ scramble[base:base + 360], ts)
    cw = DUID_CANONICAL[duid_idx]
    for k, off in enumerate(DUID_OFFSETS):
        ts[off] = (cw >> (7 - k)) & 1
    loc = {0: 0, 4: 1, 8: 2}.get(sf_pos)
    isch = (p2_xcch.isch_codeword((1 << 5) | (loc << 3))
            if (isch_first and loc is not None) else p2_xcch.ISCH_SYNC)
    for i in range(40):
        ts[320 + i] = (isch >> (39 - i)) & 1
    return ts


def p2_cc_superframes(n_superframes: int, wacn: int, sysid: int,
                      nac: int, messages_fn=None) -> np.ndarray:
    """Dibit stream of a Phase 2 TDMA CONTROL channel: every timeslot
    carries a scrambled SACCH (DUID 3) MAC PDU — MAC_IDLE headers with
    NET_STS / IDEN_UP / grant messages supplied per timeslot by
    ``messages_fn(sf, global_ts) -> list of MAC messages`` (default:
    NET_STS only).  The reference trunks such channels with
    state->p25_cc_is_tdma=1 (p25_trunk_sm.c:289)."""
    scr = p2_xcch.generate_scramble_bits(wacn, sysid, nac, 12 * 360 + 380)
    sync = next(d for d in SYNC_DEFS if d.name == "+P25p2")
    sync_d = np.array([1 if c == "1" else 3 for c in sync.pattern],
                      dtype=np.uint8)
    if messages_fn is None:
        messages_fn = lambda sf, g: [p2_mac_net_sts(wacn, sysid)]
    dibs = [np.zeros(40, np.uint8)]
    for sf in range(n_superframes):
        for frame in range(3):
            dibs.append(sync_d)
            for k in range(4):
                g = 4 * frame + k
                payload = p2_mac_payload(3, messages_fn(sf, g))
                ts = p2_xcch_ts(payload, 3, g, scramble=scr,
                                isch_first=(k == 0))
                if k == 3:
                    ts = ts[:320]     # trailing ISCH IS the next sync
                dibs.append(((ts[0::2] << 1) | ts[1::2]).astype(np.uint8))
    dibs.append(np.zeros(60, np.uint8))
    return np.concatenate(dibs)


def p2_cc_iq(dibits: np.ndarray, sps: int = 8, snr_db: float = 30.0,
             seed: int = 0) -> np.ndarray:
    """The Phase 2 control stream's modulator (``_cc_iq`` of
    ``tests/test_p2ccbatch.py``): levels ±1/±3 of 600 Hz at ``sps ·
    6000`` Hz, a moving average over half a symbol, complex64, and white
    noise of ``snr_db``, made in complex64 as that function makes it."""
    lv = DIBIT_LEVELS[np.asarray(dibits)]
    inst = np.repeat(lv, sps) * (1800.0 / 3.0)
    inst = np.convolve(inst, np.ones(sps // 2) / (sps // 2), mode="same")
    iq = np.exp(2j * np.pi * np.cumsum(inst)
                / (sps * 6000.0)).astype(np.complex64)
    rng = np.random.default_rng(seed)
    return iq + (rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape)
                 ).astype(np.complex64) * 10 ** (-snr_db / 20)


def p2_cc_block(dibits: np.ndarray, leads, noise_seeds, n_samples: int,
                sps: int = 8) -> np.ndarray:
    """``[C, n_samples, 2]`` float32 I/Q planes of a Phase 2 control
    stream: channel c carries ``leads[c]`` dibits of filler (dibit 0, as
    the stream's own lead) before ``dibits``, cut or padded with filler
    to ``n_samples // sps`` dibits, with noise seed ``noise_seeds[c]``."""
    n_dib = n_samples // sps
    out = np.empty((len(leads), n_dib * sps, 2), dtype=np.float32)
    for c, (lead, seed) in enumerate(zip(leads, noise_seeds)):
        d = np.zeros(n_dib, np.uint8)
        body = np.asarray(dibits, np.uint8)[:max(n_dib - int(lead), 0)]
        d[int(lead):int(lead) + len(body)] = body
        x = p2_cc_iq(d, sps, seed=int(seed))
        out[c, :, 0] = x.real
        out[c, :, 1] = x.imag
    return out
