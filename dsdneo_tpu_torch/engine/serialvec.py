"""The serial decode path's test streams: modulators and judges.

``tools/export_torch_tables.py`` builds four 60 s streams with the JAX
package's own encoders and stores them in ``data/serial_tables.npz``:

  - ``p25_*``: a P25 Phase 1 voice call at 4800 symbols/s (HDU,
    LDU1/LDU2 superframes with the Group Voice Channel User LC and the
    encryption sync, part of them ADP-keyed, a TDULC);
  - ``pv_*``: an EDACS control channel at 9600 symbols/s with ProVoice
    voice superframes between runs of its frames;
  - ``dmr_*``: a DMR BS stream at 4800 symbols/s with traffic on both
    slots: CSBKs, a confirmed rate-3/4 data call, a UDT, short-LC
    fragments in the CACH, and group calls (voice LC header, voice
    superframes with the EMB and the embedded LC, terminator), one of
    them with a talker alias, one under Basic Privacy and one under RC4
    with a PI header and the late-entry MI;
  - ``x2_*``: an X2-TDMA stream at 6000 symbols/s of dense two-slot
    voice superframes.

Here are their modulators (the P25 call as C4FM or as CQPSK with a
carrier offset, the EDACS/ProVoice stream as 2-level FSK, the DMR and
X2-TDMA streams as 4-level FSK, each with white noise at 30 dB, 48 kHz)
and the judges that hold a decode context to them: :func:`judge_p25`
(every LDU accepted with the vector's voice bits, every LC, encryption
sync and keyed frame right), :func:`judge_pv` (every EDACS frame with
its message, every ProVoice superframe with its LID, BF and frames),
:func:`judge_dmr` (every burst's lines, every AMBE frame's bits, keyed
ones decrypted, nothing else emitted) and :func:`judge_x2` (every
superframe the decoder walks, its AMBE frames' bits, nothing else).  A
judge raises ``AssertionError`` on the first wrong bit and returns its
counts.
"""

from __future__ import annotations

import functools

import numpy as np

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.crypto.keystream import dmr_basic_keystream
from dsdneo_tpu_torch.protocol.dmr.bs import DATA_TYPES
from dsdneo_tpu_torch.protocol.dmr.late_entry import mi_advance32
from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode

FS = 48000.0
P25_SPS = 10              # 4800 symbols/s
PV_SPS = 5                # 9600 symbols/s
DMR_SPS = 10              # 4800 symbols/s
DMR_DEV_HZ = 1944.0       # DMR's outer deviation (ETSI TS 102 361-1)
X2_SPS = 8                # 6000 symbols/s
SNR_DB = 30.0
CQPSK_CFO_HZ = 150.0      # the CQPSK stream's carrier offset
POS_TOL = 2               # symbols between a frame's sync and its hit
P25_LDU_DIBITS = 863
PV_SUPERFRAME_DIBITS = 32 + 736
EDACS_FRAME_DIBITS = 288


@functools.lru_cache(maxsize=1)
def vector() -> dict[str, np.ndarray]:
    """The arrays of ``data/serial_tables.npz``."""
    with np.load(params.SERIAL_TABLES_NPZ) as z:
        return {k: z[k] for k in z.files}


def p25_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
           cqpsk: bool = False, invert: bool = False,
           seed: int = 0) -> np.ndarray:
    """The first ``n_sym`` symbols of the P25 call (all of it by
    default) as complex64 baseband: C4FM, or π/4-DQPSK with a carrier
    offset of ``CQPSK_CFO_HZ``; ``invert`` conjugates it (an inverted
    channel)."""
    dib = tv["p25_dibits"][:n_sym]
    if cqpsk:
        x = p25_encode.cqpsk_iq(dib, P25_SPS, FS, cfo_hz=CQPSK_CFO_HZ,
                                snr_db=SNR_DB, seed=seed)
    else:
        x = p25_encode.c4fm_iq(dib, P25_SPS, FS, snr_db=SNR_DB, seed=seed)
    return np.conj(x) if invert else x


def pv_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
          invert: bool = False, seed: int = 0) -> np.ndarray:
    """The first ``n_sym`` symbols of the EDACS/ProVoice stream as
    complex64 2-level FSK baseband with white noise."""
    x = edacs_encode.fm_iq(tv["pv_dibits"][:n_sym], PV_SPS)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    x = x + noise * 10 ** (-SNR_DB / 20)
    return (np.conj(x) if invert else x).astype(np.complex64)


def _noisy(x: np.ndarray, invert: bool, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    x = x + noise * 10 ** (-SNR_DB / 20)
    return (np.conj(x) if invert else x).astype(np.complex64)


def dmr_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
           start: int = 0, invert: bool = False,
           seed: int = 0) -> np.ndarray:
    """Symbols ``[start, start + n_sym)`` of the DMR stream (to its end
    by default) as complex64 4-level FSK baseband (DMR's ±1944 Hz outer
    deviation, shaped as ``protocol.p25.encode.c4fm_clean`` shapes) with
    white noise; ``invert`` conjugates it."""
    dib = tv["dmr_dibits"][start:None if n_sym is None else start + n_sym]
    return _noisy(p25_encode.c4fm_clean(dib, DMR_SPS, FS, DMR_DEV_HZ),
                  invert, seed)


def x2_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
          seed: int = 0) -> np.ndarray:
    """The first ``n_sym`` symbols of the X2-TDMA stream as complex64
    4-level FSK baseband (the X2 vectors' modulator,
    ``protocol.p25.encode.tdma_fm_iq``) with white noise."""
    return _noisy(p25_encode.tdma_fm_iq(tv["x2_dibits"][:n_sym], X2_SPS),
                  False, seed)


class ImbeSink:
    """An ``mbe_sink`` that keeps every voice frame's parameter bits
    (after the decrypt) and its ECC error count, in decode order."""

    def __init__(self):
        self.bits: list[np.ndarray] = []
        self.errs: list[int] = []

    def write(self, bits88, errs) -> None:
        self.bits.append(np.asarray(bits88, np.uint8).copy())
        self.errs.append(int(errs))


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def _near(events, pos: int, pred) -> list:
    return [e for e in events if abs(e.pos - pos) <= POS_TOL and pred(e)]


def _one(events, pos: int, what: str, pred):
    got = _near(events, pos, pred)
    _require(len(got) == 1, f"{what} at symbol {pos}: {len(got)} events")
    return got[0]


def judge_p25(tv: dict[str, np.ndarray], ctx, sink: ImbeSink,
              n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the P25 call's first ``n_sym`` symbols to the
    vector: the HDU; every LDU whose frame the span holds accepted with
    its nine voice frames' bits and, through ``sink``, their clear
    parameter bits (the keyed ones decrypted); the LC of every LDU1 and
    of the TDULC; the encryption sync of every LDU2."""
    n_sym = len(tv["p25_dibits"]) if n_sym is None else n_sym
    nac, tg, src, _key, kid, _seed = (int(v) for v in tv["p25_ids"])
    ev = [e for e in ctx.events if e.protocol == "p25p1"]
    hdu = _one(ev, int(tv["p25_hdu_pos"]), "HDU",
               lambda e: e.line.startswith(" HDU"))
    _require((hdu.fields["algid"], hdu.fields["tgid"]) == (0x80, tg),
             hdu.line)
    imbe = np.unpackbits(tv["p25_imbe"], axis=-1)[..., :144]
    clear = np.unpackbits(tv["p25_clear88"], axis=-1)[..., :88]
    n = int(np.sum(tv["p25_ldu_pos"] + P25_LDU_DIBITS <= n_sym))
    _require(len(sink.bits) >= 9 * n, (len(sink.bits), n))
    keyed = 0
    for i in range(n):
        p, duid = int(tv["p25_ldu_pos"][i]), int(tv["p25_ldu_duid"][i])
        name = "LDU1" if duid == 0x5 else "LDU2"
        head = _one(ev, p, name + " header",
                    lambda e: e.fields.get("duid") == duid)
        _require(head.fields["nac"] == nac, head.line)
        voice = _one(ev, p, name + " voice", lambda e: "imbe" in e.fields)
        np.testing.assert_array_equal(voice.fields["imbe"], imbe[i],
                                      err_msg=f"{name} {i} voice bits")
        np.testing.assert_array_equal(
            np.stack(sink.bits[9 * i:9 * i + 9]), clear[i],
            err_msg=f"{name} {i} clear parameter bits")
        keyed += bool(tv["p25_keyed"][i])
        if duid == 0x5:
            lc = _one(ev, p, "LDU1 LC", lambda e: "src" in e.fields)
            _require((lc.fields["tg"], lc.fields["src"]) == (tg, src),
                     lc.line)
        else:
            es = _one(ev, p, "LDU2 ESS", lambda e: "kid" in e.fields)
            want = tuple(int(v) for v in tv["p25_ess"][i // 2])
            _require((es.fields["algid"], es.fields["kid"]) == want,
                     es.line)
    tp = int(tv["p25_tdulc_pos"])
    if tp + 200 <= n_sym:
        lc = _one(ev, tp, "TDULC LC", lambda e: "src" in e.fields)
        _require((lc.fields["tg"], lc.fields["src"]) == (tg, src), lc.line)
    return {"ldus": n, "keyed_ldus": keyed, "voice_frames": 9 * n}


def judge_pv(tv: dict[str, np.ndarray], ctx,
             n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the EDACS/ProVoice stream's first ``n_sym``
    symbols to the vector: every EDACS frame the span holds with its
    message word, every ProVoice superframe with its LID, BF and four
    7×24 IMBE-7100 frames."""
    n_sym = len(tv["pv_dibits"]) if n_sym is None else n_sym
    ed = [e for e in ctx.events if e.protocol == "edacs"]
    pv = [e for e in ctx.events if e.protocol == "provoice"]
    n_e = 0
    for p, w in zip(tv["pv_edacs_pos"], tv["pv_edacs_word"]):
        if p + EDACS_FRAME_DIBITS > n_sym:
            break
        e = _one(ed, int(p), "EDACS frame", lambda e: "word" in e.fields)
        _require(e.fields["word"] == int(w), e.line)
        n_e += 1
    frames = np.unpackbits(tv["pv_frames"], axis=-1)[..., :24]
    n_p = 0
    for i, p in enumerate(tv["pv_pos"]):
        if p + PV_SUPERFRAME_DIBITS > n_sym:
            break
        e = _one(pv, int(p), "ProVoice superframe",
                 lambda e: "lid" in e.fields)
        _require((e.fields["lid"], e.fields["bf"]) == (
            int(tv["pv_lid"][i]), int(tv["pv_bf"][i])), e.line)
        np.testing.assert_array_equal(e.fields["imbe7100_frames"], frames[i],
                                      err_msg=f"ProVoice {i} frames")
        n_p += 1
    return {"edacs_frames": n_e, "provoice_superframes": n_p}


def _field_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a == b


def events_equal(a, b) -> str | None:
    """None when two event lists agree in every line, protocol, position
    and field (arrays bit for bit), else where they first differ."""
    if len(a) != len(b):
        return f"{len(a)} events vs {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if (x.line, x.protocol, x.pos) != (y.line, y.protocol, y.pos):
            return f"event {i}: {x.line!r}@{x.pos} vs {y.line!r}@{y.pos}"
        if sorted(x.fields) != sorted(y.fields) or not all(
                _field_equal(x.fields[k], y.fields[k]) for k in x.fields):
            return f"event {i} ({x.line!r}): fields differ"
    return None


def pcm(ctx, slot: int = 0) -> np.ndarray:
    """The decode's PCM of ``slot``, concatenated (float32)."""
    return (np.concatenate(ctx.audio[slot]) if ctx.audio.get(slot)
            else np.zeros(0, np.float32))


# -- DMR ---------------------------------------------------------------------
def _lights(slot: int) -> str:
    return "[slot1]  slot2 " if slot == 0 else " slot1  [slot2]"


def dmr_expected_frames(tv: dict[str, np.ndarray], rc4: bool,
                        bp: bool) -> np.ndarray:
    """``[F, 49]`` the parameter bits the DMR decoder hands the vocoder
    for every frame of the stream: the on-air bits, RC4-decrypted where
    the call is RC4 and the decoder holds the key (``rc4``), then XORed
    with the Basic Privacy keystream of the vector's key ID where the
    decoder is given it (``bp``; every frame, as ``dmr_bp_key_id``
    applies to all)."""
    out = np.unpackbits(tv["dmr_ambe_onair"], axis=-1)[:, :49]
    if rc4:
        out = out ^ np.unpackbits(tv["dmr_ambe_rc4ks"], axis=-1)[:, :49]
    if bp:
        out = out ^ dmr_basic_keystream(int(tv["dmr_ids"][4]))[None, :]
    return out


def judge_dmr(tv: dict[str, np.ndarray], ctx, sink: ImbeSink,
              start: int = 0, n_sym: int | None = None,
              invert: bool = False, rc4: bool = False,
              bp: bool = False) -> dict[str, int]:
    """Hold a decode of symbols ``[start, start + n_sym)`` of the DMR
    stream to the vector.  Every event lies at a burst of the vector
    (or, at position 0, is an RC4 superframe's MI refresh).  Every burst
    the span holds whole gives its lines exactly: a data burst its
    header with the JAX decoder's detail (CSBK catalog, data header,
    the data call's blocks with the CRC32 verdict and text, the UDT
    text, the PI header, the LC's target and source) and its CACH's
    short LC, and the catalog's and the full LC's lines before it; a
    voice burst its VC line with the 216 on-air bits.  Every superframe
    it holds whole gives its embedded LC (or talker alias) and, under
    RC4, its MI refresh.  Through ``sink`` every AMBE frame's bits are
    the vector's (``dmr_expected_frames``), with no ECC error: the
    keyed calls' frames decrypt to their clear bits where the decode
    holds their key."""
    n_sym = len(tv["dmr_dibits"]) - start if n_sym is None else n_sym
    pol = "-" if invert else "+"
    bpos = tv["dmr_burst_pos"] - start
    btype, bcall = tv["dmr_burst_type"], tv["dmr_burst_call"]
    calls = tv["dmr_calls"]
    whole = (bpos - 66 >= 0) & (bpos + 78 <= n_sym)
    ev = [e for e in ctx.events if e.protocol == "dmr"]
    at: dict[int, list] = {}
    refresh = []
    for e in ev:
        if e.pos == 0 and e.line.startswith(" Slot") and "PI C-" in e.line:
            refresh.append(e)
            continue
        b = int(np.searchsorted(bpos, e.pos - POS_TOL))
        _require(b < len(bpos) and abs(int(bpos[b]) - e.pos) <= POS_TOL,
                 f"an event off the vector's bursts: {e.line!r}@{e.pos}")
        at.setdefault(b, []).append(e)
    f72 = np.unpackbits(tv["dmr_ambe72"], axis=-1)[:, :72]
    fb = tv["dmr_frame_burst"]
    first_frame = np.searchsorted(fb, np.arange(len(bpos)))
    cc = int(tv["dmr_ids"][0])
    got = {"data_bursts": 0, "csbks": 0, "voice_bursts": 0,
           "superframes": 0, "lcs": 0, "rc4_refresh": 0}
    slc_ok = np.ones(len(bpos), bool)
    synced = np.flatnonzero((btype < 16) | (btype == 17))
    for i, b in enumerate(synced):
        # a C_SYS_PARMS short LC is whole where its first fragment is
        if tv["dmr_burst_slc"][b].startswith("SLC_C"):
            slc_ok[b] = i >= 3 and bool(whole[synced[i - 3]])
    for b in np.flatnonzero(whole):
        s, t, k = int(b) % 2, int(btype[b]), int(bcall[b])
        evs = at.get(int(b), [])
        slc = str(tv["dmr_burst_slc"][b])
        tail = f"\n {slc}" if slc else ""
        if t < 16:
            head = (f"Sync: {pol}DMR {_lights(s)} | Color Code={cc:02d} | "
                    f"{DATA_TYPES[t]}{tv['dmr_burst_text'][b]}")
            want = [x for x in str(tv["dmr_burst_extra"][b]).split("\n")
                    if x]
            if t in (1, 2):
                c = calls[k]
                label = "VLC" if t == 1 else "TLC"
                want.append(f" Slot {s + 1} - {label} Group TGT={c[1]} "
                            f"SRC={c[2]} FID=0x00"
                            + (" Privacy" if c[4] else ""))
                if t == 2:
                    want.append(f" Slot {s + 1} - Call End (TLC)")
                got["lcs"] += 1
            lines = [e.line for e in evs]
            _require(len(lines) == len(want) + 1
                     and lines[:-1] == want, (int(b), lines, want))
            main = evs[-1]
            _require(main.line == head + tail or (
                not slc_ok[b] and main.line.startswith(head)),
                (int(b), main.line, head + tail))
            _require((main.fields.get("cc"), main.fields.get("dtype"),
                      main.fields.get("slot")) == (cc, t, s), main.line)
            got["data_bursts"] += 1
            got["csbks"] += t == 3
            continue
        vc = t - 16
        if not whole[b - 2 * (vc - 1)]:
            continue                # its superframe began before the span
        voice = [e for e in evs if e.line.startswith("Sync:")]
        _require(len(voice) == 1, (int(b), [e.line for e in evs]))
        v = voice[0]
        want = f"Sync: {pol}DMR {_lights(s)} | Color Code="
        _require(v.line.startswith(want) and v.line[len(want) + 2:] ==
                 f" | VC{vc}" + (tail if vc == 1 else ""), v.line)
        _require(v.line[len(want):len(want) + 2] in (f"{cc:02d}", "XX"),
                 v.line)
        np.testing.assert_array_equal(
            v.fields["ambe216"], f72[first_frame[b]:first_frame[b] + 3]
            .reshape(-1), err_msg=f"burst {b} on-air AMBE bits")
        got["voice_bursts"] += 1
        if vc != 1 or not whole[min(b + 10, len(bpos) - 1)]:
            continue
        # the superframe, whole: its embedded LC at the VC1 position
        c = calls[k]
        lc = [e for e in evs if not e.line.startswith("Sync:")]
        _require(len(lc) == 1, (int(b), [e.line for e in lc]))
        if "Talker Alias" in lc[0].line:
            _require(lc[0].line.startswith(f" Slot {s + 1} - Talker Alias"),
                     lc[0].line)
        else:
            _require(lc[0].line == f" Slot {s + 1} - Embedded LC Group TGT="
                     f"{c[1]} SRC={c[2]} FID=0x00"
                     + (" Privacy" if c[4] else ""), lc[0].line)
            _require((lc[0].fields["tg"], lc[0].fields["src"]) ==
                     (int(c[1]), int(c[2])), lc[0].line)
            got["lcs"] += 1
        got["superframes"] += 1
    # the talker alias, whole where its call is
    for k in np.flatnonzero(calls[:, 5]):
        bs = np.flatnonzero((bcall == k) & (btype == 17))
        if len(bs) >= 3 and whole[bs[0]] and whole[bs[2] + 10]:
            text = " Talker Alias: " + str(tv["dmr_alias"])
            _require(any(e.line.endswith(text) and "Block Num: 2" in e.line
                         for e in at.get(int(bs[2]), [])), text)
    # RC4: one MI refresh per superframe the decode walks, in order
    mi_want = []
    for k in np.flatnonzero(calls[:, 4] == 2):
        bs = np.flatnonzero((bcall == k) & (btype == 17))
        pi = np.flatnonzero((bcall == k) & (btype == 0))
        if len(pi) and bpos[pi[0]] - 66 >= 0:
            mi = int(tv["dmr_ids"][3])
            for b in bs:
                mi = mi_advance32(mi)
                if bpos[b] + 10 * 144 + 78 <= n_sym and bpos[b] >= 66:
                    mi_want.append(f" Slot {int(calls[k][0]) + 1} DMR PI "
                                   f"C- ALG ID: 21; KEY ID: "
                                   f"{int(tv['dmr_ids'][2]):02X}; MI(32): "
                                   f"{mi:08X}; RC4;")
    _require([e.line for e in refresh] == mi_want,
             ([e.line for e in refresh], mi_want))
    got["rc4_refresh"] = len(refresh)
    # every AMBE frame, in decode order
    want = dmr_expected_frames(tv, rc4, bp)
    order = []
    for e in ev:
        if "ambe216" in e.fields:
            b = int(np.searchsorted(bpos, e.pos - POS_TOL))
            order.extend(range(first_frame[b], first_frame[b] + 3))
    _require(len(sink.bits) == len(order), (len(sink.bits), len(order)))
    if order:
        np.testing.assert_array_equal(np.stack(sink.bits), want[order],
                                      err_msg="AMBE parameter bits")
        _require(not any(sink.errs), "AMBE ECC errors")
    cipher = tv["dmr_frame_cipher"][order]
    got["frames"] = len(order)
    got["rc4_frames"] = int(np.sum(cipher == 2)) if rc4 else 0
    got["bp_frames"] = int(np.sum(cipher == 1)) if bp else 0
    return got


# -- X2-TDMA -----------------------------------------------------------------
class AmbeSpy:
    """Records the 49 parameter bits of every AMBE frame handed to
    ``module.decode_ambe_2450`` (the port's ``vocoder.mbe`` or the JAX
    package's), as a context manager."""

    def __init__(self, module):
        self.module = module
        self.bits: list[np.ndarray] = []

    def __enter__(self):
        real = self.real = self.module.decode_ambe_2450

        def spy(bits49, *a, **k):
            self.bits.append(np.asarray(bits49, np.uint8).copy())
            return real(bits49, *a, **k)

        self.module.decode_ambe_2450 = spy
        return self

    def __exit__(self, *exc):
        self.module.decode_ambe_2450 = self.real


def judge_x2(tv: dict[str, np.ndarray], ctx, spy: AmbeSpy,
             n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the X2-TDMA stream's first ``n_sym`` symbols to
    the vector: every event at a slot-0 superframe's VC1 sync (the serial
    decoder walks slot 0's superframes and, inside them, passes over
    slot 1's bursts), each superframe the span holds whole with its VC
    line and one embedded-signalling line, and through ``spy`` its 18
    AMBE frames' bits equal to the vector's; the slot-0 PCM 160 samples
    a frame."""
    n_sym = len(tv["x2_dibits"]) if n_sym is None else n_sym
    vc1 = tv["x2_vc1_pos"]
    bits = np.unpackbits(tv["x2_bits49"], axis=-1)[0, :, :49]
    ev = [e for e in ctx.events if e.protocol == "x2tdma"]
    at: dict[int, list] = {}
    for e in ev:
        g = int(np.searchsorted(vc1, e.pos - POS_TOL))
        _require(g < len(vc1) and abs(int(vc1[g]) - e.pos) <= POS_TOL,
                 f"an event off the vector's superframes: {e.line!r}")
        at.setdefault(g, []).append(e)
    order = []
    for g in sorted(at):
        evs = at[g]
        _require(evs[0].line.startswith("Sync: +X2-TDMA BS VOICE VC"),
                 evs[0].line)
        if vc1[g] + 5 * 288 + 78 <= n_sym:
            _require(len(evs) == 2 and evs[1].line.startswith(
                ("       X2-TDMA LC", "       X2-TDMA ES")),
                [e.line for e in evs])
            order.extend(range(18 * g, 18 * g + 18))
    n_whole = int(np.sum(vc1 + 5 * 288 + 78 <= n_sym))
    _require(len(order) == 18 * n_whole, (len(order), n_whole))
    _require(len(spy.bits) >= len(order), (len(spy.bits), len(order)))
    np.testing.assert_array_equal(np.stack(spy.bits[:len(order)]),
                                  bits[order], err_msg="X2 AMBE bits")
    _require(len(pcm(ctx)) == 160 * len(spy.bits), len(pcm(ctx)))
    return {"superframes": n_whole, "frames": len(order)}
