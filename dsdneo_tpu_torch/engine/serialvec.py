"""The serial decode path's test streams: modulators and judges.

``tools/export_torch_tables.py`` builds nine 60 s streams with the JAX
package's own encoders (or, where it has none, by inverting its
decoders' tables) and stores them in ``data/serial_tables.npz``:

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
    voice superframes;
  - ``nxdn_*``: an NXDN traffic channel, calls of SACCH superframes
    (PF 1/4-4/4 carrying a VCALL) opening with a FACCH1 data frame and
    closing with a TX_REL, sent at 4800 symbols/s as NXDN96 and at 2400
    as NXDN48;
  - ``dpmr_*``: a dPMR channel at 2400 symbols/s: transmissions of an
    FS1 header, superframes of an FS2 part (the talkgroup, the channel
    code) and a part found by its FS3 (the source), an FS4 end;
  - ``ysf_*``: a YSF channel at 4800 symbols/s: full-rate, V/D2 (with
    DCH2 text) and V/D1 calls between header and terminator frames;
  - ``dstar_*``: a D-STAR channel at 4800 symbols/s, 2-level: RF headers
    and voice superframes whose slow data carries the header's copy,
    radio text and a DPRS position.

Here are their modulators (the P25 call as C4FM or as CQPSK with a
carrier offset, the EDACS/ProVoice stream as 2-level FSK, D-STAR as
GMSK, the others as 4-level FSK, each with white noise at 30 dB, 48
kHz) and the judges that hold a decode context to them:
:func:`judge_p25` (every LDU accepted with the vector's voice bits,
every LC, encryption sync and keyed frame right), :func:`judge_pv`
(every EDACS frame with its message, every ProVoice superframe with its
LID, BF and frames), :func:`judge_dmr` (every burst's lines, every AMBE
frame's bits, keyed ones decrypted, nothing else emitted),
:func:`judge_x2` (every superframe the decoder walks, its AMBE frames'
bits, nothing else), and :func:`judge_nxdn`, :func:`judge_dpmr`,
:func:`judge_ysf` and :func:`judge_dstar` (every frame's line with the
vector's fields, every voice frame's bits through :class:`AmbeSpy`
or, for D-STAR, in its events' fields, nothing else emitted).  A judge
raises ``AssertionError`` on the first wrong bit and returns its counts;
:func:`decode_spied` and :func:`judge` decode and judge any stream by
its mode.
"""

from __future__ import annotations

import functools

import numpy as np

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.crypto.keyring import KeyRing
from dsdneo_tpu_torch.crypto.keystream import dmr_basic_keystream
from dsdneo_tpu_torch.protocol.dmr.bs import DATA_TYPES
from dsdneo_tpu_torch.protocol.dmr.late_entry import mi_advance32
from dsdneo_tpu_torch.protocol.base import DecoderContext
from dsdneo_tpu_torch.protocol.dpmr import encode as dpmr_encode
from dsdneo_tpu_torch.protocol.dpmr.decoder import air_interface_id
from dsdneo_tpu_torch.protocol.dstar import decoder as dstar_decoder
from dsdneo_tpu_torch.protocol.dstar import encode as dstar_encode
from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
from dsdneo_tpu_torch.protocol.m17 import decoder as m17_decoder
from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode
from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode
from dsdneo_tpu_torch.protocol.ysf import decoder as ysf_decoder
from dsdneo_tpu_torch.protocol.ysf import encode as ysf_encode

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


def sinks_equal(a, b) -> bool:
    """Two decodes' voice sinks (:func:`decode_spied`'s) equal: every
    frame's bits each kept (None where an M17 payload was not
    decrypted), the M17 IP frames."""
    for p, q in zip(a, b):
        if hasattr(p, "frames"):
            if p.frames != q.frames:
                return False
            continue
        if len(p.bits) != len(q.bits) or any(
                (u is None) != (v is None)
                or (u is not None and not np.array_equal(u, v))
                for u, v in zip(p.bits, q.bits)):
            return False
    return True


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
    """Records the parameter bits of every voice frame handed to
    ``module.<name>`` (by default the 49 bits of each AMBE frame through
    ``decode_ambe_2450``; ``"decode_imbe_4400"`` takes the 88 of each
    IMBE frame), in the port's ``vocoder.mbe`` or the JAX package's, as a
    context manager."""

    def __init__(self, module, name: str = "decode_ambe_2450"):
        self.module = module
        self.name = name
        self.bits: list[np.ndarray] = []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def spy(bits, *a, **k):
            self.bits.append(np.asarray(bits, np.uint8).copy())
            return real(bits, *a, **k)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


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


# -- NXDN --------------------------------------------------------------------
NXDN_SPS = {"nxdn48": 20, "nxdn96": 10}      # 2400 and 4800 symbols/s
NXDN_FRAME_DIBITS = 192
_NXDN_KIND = {0x36: "Voice ", 0x32: "V2+F1 ", 0x20: "Data  "}


def nxdn_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
            mode: str = "nxdn48", invert: bool = False) -> np.ndarray:
    """The first ``n_sym`` symbols of the NXDN stream (60 s at ``mode``'s
    rate by default) as complex64 4-level FSK baseband at ``mode``'s rate
    and deviation (``protocol.nxdn.encode.nxdn_fm_iq``) with white noise;
    ``invert`` conjugates it."""
    sps = NXDN_SPS[mode]
    n_sym = int(60 * FS / sps) if n_sym is None else n_sym
    dev = (nxdn_encode.NXDN48_DEV_HZ if mode == "nxdn48"
           else nxdn_encode.NXDN96_DEV_HZ)
    return _noisy(nxdn_encode.nxdn_fm_iq(tv["nxdn_dibits"][:n_sym], sps,
                                         dev_hz=dev), invert, 0)


def _nxdn_vcall_text(mtype: int, src: int, dst: int) -> str:
    """The catalog's line of a VCALL (0x01) or TX_REL (0x08) with CC
    option 0, a group call and voice option 0 (4800 bps EHR)."""
    if mtype == 0x01:
        return (f" VCALL\n Group Call - Half Duplex 4800bps/EHR (00) - "
                f"Src={src} - Dst/TG={dst} ")
    return (f" TX_REL\n Group Call -   Transmission Release  - "
            f"Src={src} - Dst/TG={dst} ")


def judge_nxdn(tv: dict[str, np.ndarray], ctx, spy: AmbeSpy,
               mode: str = "nxdn48",
               n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the NXDN stream's first ``n_sym`` symbols to the
    vector: every event at a frame of the vector, and every frame the
    span holds whole with exactly its line — the variant, RTCH, the
    LICH's kind, the SACCH's RAN and part, at each superframe's fourth
    part the VCALL of the call's source and destination (where the
    span holds the superframe's four parts), and the FACCH1 VCALL or
    TX_REL; through ``spy`` every AMBE frame's 49 bits in decode order;
    the RAN in the decoder's state; PCM 160 samples a frame."""
    n_sym = int(60 * FS / NXDN_SPS[mode]) if n_sym is None else n_sym
    pos = tv["nxdn_frame_pos"]
    lich, pf = tv["nxdn_frame_lich"], tv["nxdn_frame_pf"]
    facch, calls = tv["nxdn_frame_facch"], tv["nxdn_calls"]
    ran = int(tv["nxdn_ids"][0])
    variant = mode.upper()
    bits = np.unpackbits(tv["nxdn_bits49"], axis=-1)[:, :49]
    n_ambe = np.where(lich == 0x36, 4, np.where(lich == 0x32, 2, 0))
    first = np.concatenate([[0], np.cumsum(n_ambe)[:-1]])
    whole = pos + NXDN_FRAME_DIBITS + POS_TOL <= n_sym
    ev = [e for e in ctx.events if e.protocol == "nxdn"]
    _require(len(ev) == len(ctx.events), "events of another protocol")
    got = {"frames": 0, "vcalls": 0, "facch": 0}
    order = []
    seen = set()
    for e in ev:
        f = int(np.searchsorted(pos, e.pos - POS_TOL))
        _require(f < len(pos) and abs(int(pos[f]) - e.pos) <= POS_TOL
                 and f not in seen,
                 f"an event off the vector's frames: {e.line!r}@{e.pos}")
        seen.add(f)
        src, dst = (int(v) for v in calls[tv["nxdn_frame_call"][f]])
        want = (f"Sync: {variant}  RTCH {_NXDN_KIND[int(lich[f])]}"
                f" RAN {ran:02d} PF {int(pf[f]) + 1}/4")
        if pf[f] == 3 and f >= 3 and whole[f - 3] and \
                tv["nxdn_frame_call"][f - 3] == tv["nxdn_frame_call"][f]:
            want += _nxdn_vcall_text(0x01, src, dst)
            got["vcalls"] += 1
        for m in facch[f]:
            if m >= 0:
                want += " FACCH1" + _nxdn_vcall_text(int(m), src, dst)
                got["facch"] += 1
        _require(e.line == want, (e.line, want))
        _require(e.fields.get("lich") == int(lich[f]), e.line)
        order.extend(range(first[f], first[f] + n_ambe[f]))
        got["frames"] += 1
    missing = sorted(set(np.flatnonzero(whole)) - seen)
    _require(not missing, f"frames not decoded: {missing[:8]}")
    _require(getattr(ctx.state, "nxdn_ran", None) == ran or not ev,
             "the RAN")
    _require(len(spy.bits) == len(order), (len(spy.bits), len(order)))
    if order:
        np.testing.assert_array_equal(np.stack(spy.bits), bits[order],
                                      err_msg="NXDN AMBE bits")
    _require(len(pcm(ctx)) == 160 * len(order), len(pcm(ctx)))
    got["ambe_frames"] = len(order)
    return got


# -- dPMR --------------------------------------------------------------------
DPMR_SPS = 20                 # 2400 symbols/s
DPMR_PART_DIBITS = 384


def dpmr_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
            invert: bool = False) -> np.ndarray:
    """The first ``n_sym`` symbols of the dPMR stream (all of it by
    default) as complex64 4-level FSK baseband
    (``protocol.dpmr.encode.fm_iq``: ±1050 Hz, 2400 symbols/s) with white
    noise; ``invert`` conjugates it."""
    return _noisy(dpmr_encode.fm_iq(tv["dpmr_dibits"][:n_sym], DPMR_SPS),
                  invert, 0)


def judge_dpmr(tv: dict[str, np.ndarray], ctx, spy: AmbeSpy,
               n_sym: int | None = None,
               invert: bool = False) -> dict[str, int]:
    """Hold a decode of the dPMR stream's first ``n_sym`` symbols to the
    vector: every event at a sync of the vector, and every
    frame the span holds whole with exactly its line (and any frame it
    holds in part with its line, if decoded) — the FS1 header and FS4
    end (FS4 is FS1 negated, so on an inverted channel the header reads
    as an end and the end as a header), part A at its FS2 and part B at
    its FS3, each with the talkgroup, source and channel code the
    decoder holds after it (part A brings the talkgroup and the channel
    code, part B the source; each starts unknown) and its CCHs' FN;
    through ``spy`` the 8 AMBE frames of every part, in decode order;
    PCM 160 samples a frame of each whole group of four.  The IDs are
    rendered with the port's ``air_interface_id``, held to the JAX
    package's by ``tests/test_torch_dpmr_serial.py``
    (``test_crc_tables_and_ids``)."""
    n_sym = len(tv["dpmr_dibits"]) if n_sym is None else n_sym
    pol = "-" if invert else "+"
    spos, skind = tv["dpmr_sync_pos"], tv["dpmr_sync_kind"]
    ppos, pkind = tv["dpmr_part_pos"], tv["dpmr_part_kind"]
    ptx, txs = tv["dpmr_part_tx"], tv["dpmr_tx"]
    bits = np.unpackbits(tv["dpmr_bits49"], axis=-1)[..., :49]
    at_sync, whole = {}, set()
    for i in np.flatnonzero(spos < n_sym):
        k = int(skind[i])
        lo = int(spos[i]) - (192 if k == 3 else 0)
        ln = {1: 24, 2: DPMR_PART_DIBITS, 3: DPMR_PART_DIBITS, 4: 24}[k]
        at_sync[int(spos[i])] = k
        if lo + ln + POS_TOL <= n_sym:
            whole.add(int(spos[i]))
    ev = [e for e in ctx.events if e.protocol == "dpmr"]
    _require(len(ev) == len(ctx.events), "events of another protocol")
    tg = src = cc = None
    part_at = {int(p) + (192 if k == 3 else 0): j
               for j, (p, k) in enumerate(zip(ppos, pkind))}
    order, seen = [], set()
    got = {"parts": 0, "fs3_parts": 0, "headers": 0, "ends": 0}
    for e in ev:
        at = [p for p in range(e.pos - POS_TOL, e.pos + POS_TOL + 1)
              if p in at_sync]
        _require(len(at) == 1 and at[0] not in seen,
                 f"an event off the vector's syncs: {e.line!r}@{e.pos}")
        p = at[0]
        seen.add(p)
        k = at_sync[p]
        if k in (1, 4):
            # FS4 is FS1 negated: inverted, a header reads as an end
            seen_as = (5 - k) if invert else k
            _require(e.line == {1: "Sync: +dPMR FS1  dPMR Frame Sync 1 "
                                   "(header)",
                                4: "Sync: +dPMR FS4  dPMR Frame Sync 4 "
                                   "(end)"}[seen_as], e.line)
            got["headers" if k == 1 else "ends"] += 1
            continue
        j = part_at[p]
        t_g, t_s, t_c = (int(v) for v in txs[ptx[j]])
        if k == 2:
            tg, cc = air_interface_id(t_g), t_c
        else:
            src = air_interface_id(t_s)
        want = (f"Sync: {pol}dPMR FS{k}  dPMR Frame Sync 2 \n"
                + (f" TG={tg}" if tg else " TG=(CRC ERR)"))
        if src:
            want += f" Src={src}" + (f" Channel Code={cc:02d}"
                                      if cc is not None else "")
        else:
            want += " Src=(CRC ERR) Channel Code =(CRC ERR)"
        _require(e.line == want, (e.line, want))
        _require(tuple(e.fields.get("fn", ())) == ((0, 1) if k == 2
                                                    else (2, 3)), e.line)
        order.append(j)
        got["parts"] += 1
        got["fs3_parts"] += k == 3
    missing = sorted(set(whole) - seen)
    _require(not missing, f"syncs not decoded: {missing[:8]}")
    # a part that runs past the span decodes the frames the span holds
    n_whole = sum(int(ppos[j]) + DPMR_PART_DIBITS + POS_TOL <= n_sym
                  for j in order)
    _require(8 * n_whole <= len(spy.bits) <= 8 * len(order),
             (len(spy.bits), len(order)))
    if order:
        np.testing.assert_array_equal(
            np.stack(spy.bits),
            bits[order].reshape(-1, 49)[:len(spy.bits)],
            err_msg="dPMR AMBE bits")
    # a TCH group cut by the span is read but not synthesized
    _require(len(pcm(ctx)) == 160 * 4 * (len(spy.bits) // 4), len(pcm(ctx)))
    got["ambe_frames"] = len(spy.bits)
    return got


# -- YSF ---------------------------------------------------------------------
YSF_SPS = 10                  # 4800 symbols/s
YSF_FRAME_DIBITS = 480


def ysf_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
           invert: bool = False) -> np.ndarray:
    """The first ``n_sym`` symbols of the YSF stream (all of it by
    default) as complex64 4-level FSK baseband
    (``protocol.ysf.encode.fm_iq``: ±2.4 kHz, 4800 symbols/s) with white
    noise; ``invert`` conjugates it."""
    return _noisy(ysf_encode.fm_iq(tv["ysf_dibits"][:n_sym], YSF_SPS),
                  invert, 0)


def _ysf_dch2_text(fn: int, cm: int, txt: str) -> str:
    """``YsfDecoder._dch2``'s rendering of the text of FN ``fn``."""
    return {0: (f"DST: {txt} " if cm != 1
                else f"DST RID: {txt[:5]} SRC RID: {txt[5:]} "),
            1: f"SRC: {txt}", 2: f"U/L: {txt}", 3: f"D/L: {txt}",
            4: f"RM1: {txt[:5]} RM2: {txt[5:]} ",
            5: f"RM3: {txt[:5]} RM4: {txt[5:]} "}.get(fn, "")


def judge_ysf(tv: dict[str, np.ndarray], ctx, ambe: AmbeSpy,
              imbe: AmbeSpy, n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the YSF stream's first ``n_sym`` symbols to the
    vector: every event at a frame, and every frame the span holds whole
    with exactly its line — the FICH's data type, call mode, path, frame
    type and FN/FT, and on a V/D2 communication frame the DCH2 text of
    its FN — and its ``dt``, ``fn`` and ``cm`` fields; through ``ambe``
    the AMBE frames of every V/D1 (four) and V/D2 (five) communication
    frame, through ``imbe`` the IMBE frames of every full-rate one (five,
    or two on the CSD3 frame), in decode order, and none from a header
    or terminator; PCM 160 samples a frame.  The FICH's names come from
    the port's ``DT_NAMES``, ``CM_NAMES`` and ``FI_NAMES``, held to the
    JAX package's by ``tests/test_torch_ysf_serial.py``
    (``test_crc_and_tables``)."""
    n_sym = len(tv["ysf_dibits"]) if n_sym is None else n_sym
    pos, fich, text = tv["ysf_frame_pos"], tv["ysf_fich"], \
        tv["ysf_frame_text"]
    fi, cm, fn, ft, _mr, vp, dt, _sc = (fich[:, i] for i in range(8))
    b49 = np.unpackbits(tv["ysf_bits49"], axis=-1)[:, :49]
    b88 = np.unpackbits(tv["ysf_bits88"], axis=-1)[:, :88]
    comm = fi == 1
    n_a = np.where(comm & (dt == 0), 4, np.where(comm & (dt == 2), 5, 0))
    n_i = np.where(comm & (dt == 3), np.where((ft == 1) & (fn == 0), 2, 5),
                   0)
    fa = np.concatenate([[0], np.cumsum(n_a)[:-1]])
    fimb = np.concatenate([[0], np.cumsum(n_i)[:-1]])
    whole = pos + YSF_FRAME_DIBITS + POS_TOL <= n_sym
    ev = [e for e in ctx.events if e.protocol == "ysf"]
    _require(len(ev) == len(ctx.events), "events of another protocol")
    oa, oi, seen = [], [], set()
    got = {"frames": 0, "vd1": 0, "vd2": 0, "vwfr": 0, "csd3": 0,
           "hc_tc": 0}
    for e in ev:
        f = int(np.searchsorted(pos, e.pos - POS_TOL))
        _require(f < len(pos) and abs(int(pos[f]) - e.pos) <= POS_TOL
                 and f not in seen,
                 f"an event off the vector's frames: {e.line!r}@{e.pos}")
        seen.add(f)
        want = ("Sync: +YSF  " + ysf_decoder.DT_NAMES[int(dt[f])]
                + ysf_decoder.CM_NAMES[int(cm[f])]
                + ("Repeater " if vp[f] else "-Simplex ")
                + ysf_decoder.FI_NAMES[int(fi[f])]
                + f"FN: {int(fn[f]) + 1}/{int(ft[f]) + 1} ")
        # a frame cut by the span's end gives its FICH alone
        payload = e.pos + YSF_FRAME_DIBITS <= len(ctx.dibits)
        if comm[f] and dt[f] == 2 and payload:
            want += _ysf_dch2_text(int(fn[f]), int(cm[f]), str(text[f]))
        _require(e.line == want, (e.line, want))
        _require((e.fields.get("dt"), e.fields.get("fn"), e.fields.get("cm"))
                 == (int(dt[f]), int(fn[f]), int(cm[f])), e.line)
        if payload:
            oa.extend(range(fa[f], fa[f] + n_a[f]))
            oi.extend(range(fimb[f], fimb[f] + n_i[f]))
        got["frames"] += 1
        if comm[f]:
            got[{0: "vd1", 2: "vd2", 3: "vwfr"}[int(dt[f])]] += 1
            got["csd3"] += int(n_i[f] == 2)
        else:
            got["hc_tc"] += 1
    missing = sorted(set(np.flatnonzero(whole)) - seen)
    _require(not missing, f"frames not decoded: {missing[:8]}")
    for spy, order, ref, what in ((ambe, oa, b49, "AMBE"),
                                  (imbe, oi, b88, "IMBE")):
        _require(len(spy.bits) == len(order), (what, len(spy.bits),
                                               len(order)))
        if order:
            np.testing.assert_array_equal(np.stack(spy.bits), ref[order],
                                          err_msg=f"YSF {what} bits")
    _require(len(pcm(ctx)) == 160 * (len(oa) + len(oi)), len(pcm(ctx)))
    got["ambe_frames"], got["imbe_frames"] = len(oa), len(oi)
    return got


# -- D-STAR ------------------------------------------------------------------
DSTAR_SPS = 10                # 4800 symbols/s
DSTAR_HEADER_DIBITS = 684     # the header sync and 660 coded bits
DSTAR_SUPERFRAME_DIBITS = 2016


def dstar_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
             invert: bool = False) -> np.ndarray:
    """The first ``n_sym`` symbols of the D-STAR stream (all of it by
    default) as complex64 GMSK baseband (``protocol.dstar.encode.fm_iq``)
    with white noise; ``invert`` conjugates it."""
    return _noisy(dstar_encode.fm_iq(tv["dstar_dibits"][:n_sym],
                                     DSTAR_SPS), invert, 0)


def judge_dstar(tv: dict[str, np.ndarray], ctx,
                n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the D-STAR stream's first ``n_sym`` symbols to the
    vector: every event at a header or a superframe, and each the span
    holds whole with exactly its line and fields (a header cut by the
    span's end with its sync's line) — a header's octets
    (MYCALL, URCALL, RPT1, RPT2, the CRC right), a superframe's slow
    data (the header's copy with the call's MYCALL, its radio text, or
    the DPRS position), its 21 frames' on-air bits and their 49 AMBE
    parameter bits with no ECC error; no PCM (the 3600x2400 parameters
    are not synthesized).  The header and slow-data lines are rendered
    with the port's ``header_line`` and ``slow_data_line``, held to the
    JAX package's by ``tests/test_torch_dstar_serial.py``
    (``test_slow_data``, and ``test_dstar_stream`` for the headers)."""
    n_sym = len(tv["dstar_dibits"]) if n_sym is None else n_sym
    hd, sf = tv["dstar_hd_pos"], tv["dstar_sf_pos"]
    voice = np.unpackbits(tv["dstar_sf_voice"], axis=-1)[..., :72]
    bits = np.unpackbits(tv["dstar_sf_bits49"], axis=-1)[..., :49]
    frames = {int(p): ("hd", i) for i, p in enumerate(hd)}
    frames.update({int(p): ("sf", i) for i, p in enumerate(sf)})
    ext = {"hd": DSTAR_HEADER_DIBITS, "sf": DSTAR_SUPERFRAME_DIBITS}
    whole = {p for p, (k, _i) in frames.items()
             if p + ext[k] + POS_TOL <= n_sym}
    ev = [e for e in ctx.events if e.protocol == "dstar"]
    _require(len(ev) == len(ctx.events), "events of another protocol")
    got = {"headers": 0, "superframes": 0, "text": 0, "dprs": 0,
           "header_copies": 0}
    seen = set()
    for e in ev:
        at = [p for p in range(e.pos - POS_TOL, e.pos + POS_TOL + 1)
              if p in frames]
        _require(len(at) == 1 and at[0] not in seen,
                 f"an event off the vector's frames: {e.line!r}@{e.pos}")
        seen.add(at[0])
        kind, i = frames[at[0]]
        scratch = DecoderContext()
        if kind == "hd" and e.pos + DSTAR_HEADER_DIBITS > len(ctx.dibits):
            # a header cut by the span's end: its sync alone
            _require(e.line == "Sync: +D-STAR HD HEADER", e.line)
            continue
        if kind == "hd":
            oct41 = tv["dstar_hd_octets"][i]
            line, crc_ok, fields = dstar_decoder.header_line(oct41, scratch)
            _require(crc_ok, "the vector's header CRC")
            _require(e.line == "Sync: +D-STAR HD HEADER  " + line,
                     (e.line, line))
            _require(all(e.fields.get(k) == v for k, v in fields.items()),
                     e.line)
            got["headers"] += 1
            continue
        if at[0] not in whole:
            continue
        sd = tv["dstar_sf_sd"][i]
        line = dstar_decoder.slow_data_line(sd, scratch)
        k = int(tv["dstar_sf_kind"][i])
        call = str(scratch.state.last_src) if k == 0 else ""
        _require({0: call != "" and f"SRC: {call}" in line,
                  1: line.startswith("SLOW DATA TEXT: "),
                  2: "APRS - Lat: 49d 03m 50s N" in line}[k], line)
        _require(e.line == "Sync: +D-STAR VOICE  " + line, (e.line, line))
        np.testing.assert_array_equal(e.fields["voice"], voice[i],
                                      err_msg=f"superframe {i} voice bits")
        np.testing.assert_array_equal(e.fields["ambe49"], bits[i],
                                      err_msg=f"superframe {i} AMBE bits")
        _require(not np.any(e.fields["ambe_errs"]), "AMBE ECC errors")
        got["superframes"] += 1
        got[("header_copies", "text", "dprs")[k]] += 1
    missing = sorted(whole - seen)
    _require(not missing, f"frames not decoded: {missing[:8]}")
    _require(not ctx.audio, "D-STAR PCM")
    return got


# -- M17 ---------------------------------------------------------------------
M17_SPS = 10                  # 4800 symbols/s
M17_FRAME_DIBITS = 192        # an 8-symbol sync and 184 symbols
M17_LSF, M17_STR, M17_SIG, M17_PKT, M17_BRT, M17_PRE = range(6)


def m17_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
           invert: bool = False) -> np.ndarray:
    """The first ``n_sym`` symbols of the M17 stream (all of it by
    default) as complex64 4-level FSK baseband at M17's 2.4 kHz outer
    deviation (``protocol.m17.encode.fm_iq``) with white noise;
    ``invert`` conjugates it."""
    return _noisy(m17_encode.fm_iq(tv["m17_dibits"][:n_sym], M17_SPS),
                  invert, 0)


def m17_attrs(tv: dict[str, np.ndarray]) -> dict:
    """The M17 keys as ``state_attrs``: the scrambler seed, the AES key
    and the signed streams' public key."""
    return {"m17_scrambler_key": int(tv["m17_ids"][1]),
            "m17_aes_key": tv["m17_aes_key"].tobytes(),
            "m17_pubkey": tv["m17_pubkey"].tobytes()}


class M17Spy:
    """Records, in decode order, the 128-bit payload each M17 voice frame
    hands Codec2 (the return of ``cls._decrypt``: decrypted, or None
    where it cannot be), for the port's ``M17Decoder`` or the JAX
    package's, as a context manager."""

    def __init__(self, cls):
        self.cls = cls
        self.bits: list[np.ndarray | None] = []

    def __enter__(self):
        real = self.real = self.cls._decrypt

        def spy(dec, v128, fn, ctx):
            out = real(dec, v128, fn, ctx)
            self.bits.append(None if out is None
                             else np.asarray(out, np.uint8).copy())
            return out

        self.cls._decrypt = spy
        return self

    def __exit__(self, *exc):
        self.cls._decrypt = self.real


def m17_pcm_fresh(n_sym: int | None = None, device: str = "cpu",
                  invert: bool = False) -> np.ndarray:
    """The PCM of the port's decode of the M17 stream's first ``n_sym``
    symbols on ``device``, decoded in a fresh Python process: libcodec2
    draws its unvoiced excitation from one noise generator for the whole
    process, so two decodes of one stream in one process differ, and
    only decodes that each start a process compare."""
    import os
    import subprocess
    import sys
    import tempfile
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "pcm.npy")
        code = ("import numpy as np\n"
                "from dsdneo_tpu_torch.engine import decoder\n"
                "from dsdneo_tpu_torch.engine import serialvec as SV\n"
                "tv = SV.vector()\n"
                f"ctx = decoder.decode_samples(SV.m17_iq(tv, {n_sym}, "
                f"{invert}), 'm17', device={device!r}, "
                "state_attrs=SV.m17_attrs(tv))\n"
                f"np.save({out!r}, SV.pcm(ctx))\n")
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       check=True, timeout=600)
        return np.load(out)


class UdpSink:
    """An ``m17_udp`` that keeps the M17 IP frames the decoder sends."""

    def __init__(self):
        self.frames: list[bytes] = []

    def send(self, frame: bytes) -> None:
        self.frames.append(bytes(frame))


def _prbs9_lock(bits: np.ndarray, st: dict) -> None:
    """The M17 BERT receiver over ``bits`` (PRBS9 x⁹ + x⁵ + 1): unlocked,
    it counts consecutive predicted bits, shifting in what it hears, and
    locks at 18; locked, it counts bits and errors."""
    for b in bits:
        s = st["lfsr"]
        exp = ((s >> 8) ^ (s >> 4)) & 1
        if st["locked"]:
            st["lfsr"] = ((s << 1) | exp) & 0x1FF
            st["bits"] += 1
            st["errors"] += exp != int(b)
        else:
            st["lock"] = st["lock"] + 1 if exp == int(b) else 0
            st["lfsr"] = ((s << 1) | int(b)) & 0x1FF
            st["locked"] = st["lock"] >= 18


def _sig_bytes(line: str) -> bytes:
    """The 16 bytes a signature frame's line shows as ``[AB][CD]…``."""
    return bytes.fromhex(line.split(" SIG: ", 1)[1][:64]
                         .replace("[", "").replace("]", ""))


def _prbs9(n: int, state: int) -> np.ndarray:
    out = np.zeros(n, np.uint8)
    for i in range(n):
        bit = ((state >> 8) ^ (state >> 4)) & 1
        state = ((state << 1) | bit) & 0x1FF
        out[i] = bit
    return out


def _m17_lsf_text(can: int, dst: int, src: int) -> str:
    return (f"\n CAN: {can} DST: {m17_decoder.decode_callsign(dst)}"
            f" SRC: {m17_decoder.decode_callsign(src)}")


def judge_m17(tv: dict[str, np.ndarray], ctx, spy: M17Spy, udp: UdpSink,
              n_sym: int | None = None) -> dict[str, int]:
    """Hold a decode of the M17 stream's first ``n_sym`` symbols (with
    :func:`m17_attrs`' keys) to the vector: every event at a frame of
    the vector, and every frame the span holds whole with exactly its
    line and fields — an LSF's CAN, callsigns, data type, cipher and
    META (text, GNSS, extended callsign), a stream frame's LICH counter,
    FN, EOT, the LSF the LICH completes, A_DATA text and the signature
    frames' bytes (the last "COMPLETE; VERIFIED;", the signature checked
    here against the digest of the stream's on-air payloads), an SMS
    packet's blocks and text, a BERT frame's lock and counts (the first
    frame of the run shadowed by the preamble's LSF hit); every voice
    payload handed to Codec2 through ``spy`` (clear, the scrambler's
    and AES-CTR's decrypted) and sent to ``udp`` (on air) bit for bit;
    320 PCM samples a voice frame where libcodec2 loads, none where
    not."""
    from dsdneo_tpu_torch.crypto.ecdsa import p256_verify_digest
    from dsdneo_tpu_torch.protocol.m17.ip import parse_ip_frame
    from dsdneo_tpu_torch.vocoder import codec2
    n_sym = len(tv["m17_dibits"]) if n_sym is None else n_sym
    fr = tv["m17_frames"]
    ext = {M17_LSF: 200, M17_PRE: 200}
    whole = [int(p) + ext.get(int(k), M17_FRAME_DIBITS) + POS_TOL <= n_sym
             for p, k in fr[:, :2]]
    ev = [e for e in ctx.events if e.protocol == "m17"]
    _require(len(ev) == len(ctx.events), "events of another protocol")
    at = {}
    for e in ev:
        i = int(np.searchsorted(fr[:, 0], e.pos - POS_TOL))
        _require(i < len(fr) and abs(int(fr[i, 0]) - e.pos) <= POS_TOL
                 and i not in at,
                 f"an event off the vector's frames: {e.line!r}@{e.pos}")
        at[i] = e
    missing = [i for i in range(len(fr)) if whole[i] and i not in at]
    _require(not missing, f"frames not decoded: {fr[missing[:4], 0]}")
    onair = np.unpackbits(tv["m17_onair"], axis=-1)
    handed = np.unpackbits(tv["m17_handed"], axis=-1)
    bert = {"lfsr": 1, "lock": 0, "locked": False, "bits": 0, "errors": 0}
    got = {"lsfs": 0, "voice_frames": 0, "decrypted": 0, "verified": 0,
           "sms": 0, "bert_frames": 0, "lsf_from_lich": 0}
    order = []
    for i, (_p, kind, t, fn, cnt, row) in enumerate(fr.tolist()):
        if i not in at:
            continue
        e = at[i]
        _kind, can, tw, *_frames, state = tv["m17_tx"][t].tolist()
        dst, src = tv["m17_tx_calls"][t].tolist()
        dt, enc = (tw >> 1) & 3, (tw >> 3) & 3
        if kind == M17_PRE:
            _require(e.line == "Sync: +M17 LSF  CRC ERR", e.line)
            continue
        if kind == M17_LSF:
            want = ("Sync: +M17 LSF " + _m17_lsf_text(can, dst, src)
                    + (m17_decoder.DT_NAMES.get(dt, "") if tw & 1
                       else " Packet")
                    + (m17_decoder.ENC_NAMES.get(enc, "")
                       if tw & 1 and enc else "")
                    + str(tv["m17_tx_note"][t]))
            _require(e.line == want, (e.line, want))
            _require(e.fields == {"dst": dst, "src": src, "type": tw},
                     e.fields)
            got["lsfs"] += 1
            continue
        if kind == M17_PKT:
            npk = int(np.sum((fr[:, 1] == M17_PKT) & (fr[:, 2] == t)))
            if cnt < npk - 1:
                _require(e.line == f"Sync: +M17 PKT BLK: {cnt:02d}", e.line)
                continue
            text = str(tv["m17_sms"][row])
            app = np.frombuffer(b"\x05" + text.encode() + b"\0", np.uint8)
            _require(e.line == f"Sync: +M17 PKT EOF ({len(app)} bytes)"
                     f"\n SMS: {text}", e.line)
            np.testing.assert_array_equal(e.fields["payload"], app)
            got["sms"] += 1
            continue
        if kind == M17_BRT:
            _prbs9_lock(_prbs9(197 * (cnt + 1), state)[197 * cnt:], bert)
            tag = "LOCK" if bert["locked"] else "SYNCING"
            _require(e.line == f"Sync: +M17 BRT BERT: {tag} bits:"
                     f"{bert['bits']} errors:{bert['errors']}", e.line)
            _require(bert["locked"] and not bert["errors"], e.line)
            got["bert_frames"] += 1
            continue
        line = f"Sync: +M17 STR LC: {cnt + 1}/6 FN: {fn & 0x7FFF:04X} "
        if fn & 0x8000:
            line += "EOT "
        _require(e.fields == {"lich_cnt": cnt, "fn": fn & 0x7FFF},
                 (e.line, e.fields))
        if kind == M17_SIG:
            _require(e.line.startswith(line + " SIG: ")
                     and len(_sig_bytes(e.line)) == 16, e.line)
            if fn == 0xFFFF:
                _require(e.line.endswith(" COMPLETE; VERIFIED;"), e.line)
                got["verified"] += 1
            continue
        # the LICH completes an LSF at a counter-5 frame after five
        # frames of counters 0-4 of this transmission
        prev = fr[max(i - 5, 0):i]
        if (cnt == 5 and i >= 5 and np.all(prev[:, 2] == t)
                and np.array_equal(prev[:, 4], np.arange(5))
                and np.all(np.isin(prev[:, 1], (M17_STR, M17_SIG)))):
            line += (_m17_lsf_text(can, dst, src)
                     + m17_decoder.DT_NAMES.get(dt, "")
                     + (m17_decoder.ENC_NAMES.get(enc, "") if enc else ""))
            got["lsf_from_lich"] += 1
        if dt == 3:
            v2 = np.packbits(handed[row, 64:]).tobytes()
            text = v2.split(b"\0")[0].decode("utf-8", "replace")
            if text and all(31 < ord(c) < 127 for c in text):
                line += f"\n A_DATA: {text}"
        _require(e.line == line, (e.line, line))
        order.append(row)
        got["voice_frames"] += 1
        got["decrypted"] += bool(enc) and not np.array_equal(handed[row],
                                                             onair[row])
    _require(len(spy.bits) >= len(order), (len(spy.bits), len(order)))
    for k, row in enumerate(order):
        _require(spy.bits[k] is not None, f"voice frame {row} not decrypted")
        np.testing.assert_array_equal(spy.bits[k], handed[row],
                                      err_msg=f"M17 voice frame {row}")
    ip = [parse_ip_frame(f) for f in udp.frames]
    _require(len(ip) >= len(order), (len(ip), len(order)))
    for k, row in enumerate(order):
        _require(ip[k].kind == "stream" and ip[k].crc_ok, ip[k])
        np.testing.assert_array_equal(ip[k].voice, onair[row],
                                      err_msg=f"M17 IP frame {row}")
    # each signed stream's signature over its on-air payloads' digest
    for t in np.flatnonzero((tv["m17_tx"][:, 2] >> 11) & 1):
        rows = fr[(fr[:, 2] == t) & (fr[:, 1] == M17_STR), 5]
        digest = bytearray(16)
        for r in rows:
            d = bytes(a ^ b for a, b in zip(digest, tv["m17_onair"][r]))
            digest = bytearray(d[1:] + d[:1])
        sig = b"".join(_sig_bytes(at[i].line)
                       for i in np.flatnonzero((fr[:, 2] == t)
                                               & (fr[:, 1] == M17_SIG))
                       if i in at)
        if len(sig) == 64:
            _require(p256_verify_digest(bytes(digest),
                                        tv["m17_pubkey"].tobytes(), sig),
                     f"the signature of transmission {t}")
    n_pcm = len(pcm(ctx))
    _require(n_pcm == (320 * len(spy.bits) if codec2.available() else 0),
             (n_pcm, len(spy.bits)))
    return got


# -- P25 Phase 2 -------------------------------------------------------------
P2_SPS = 8                    # 6000 symbols/s
P2_FRAME_DIBITS = 720


def p2_iq(tv: dict[str, np.ndarray], n_sym: int | None = None,
          invert: bool = False) -> np.ndarray:
    """The first ``n_sym`` symbols of the P25p2 stream (all of it by
    default) as complex64 4-level FSK baseband (the JAX package's P25p2
    modulator, ``protocol.p25.encode.tdma_fm_iq``) with white noise;
    ``invert`` conjugates it."""
    return _noisy(p25_encode.tdma_fm_iq(tv["p2_dibits"][:n_sym], P2_SPS),
                  invert, 0)


def p2_params(tv: dict[str, np.ndarray]) -> tuple[int, int, int]:
    """The stream's (WACN, SYSID, NAC), the -X flag's ``p2_params``."""
    return tuple(int(v) for v in tv["p2_ids"][:3])


def judge_p2(tv: dict[str, np.ndarray], ctx, spy: AmbeSpy,
             n_sym: int | None = None, keyed: bool = True,
             blind: bool = False) -> dict[str, int]:
    """Hold a decode of the P25p2 stream's first ``n_sym`` symbols to the
    vector: every frame the span holds whole with exactly its events —
    the sync line ("P2 Missing Parameters" until the scramble parameters
    are known), each timeslot's DUID, superframe position and line: the
    4V/2V voice (each 2V with the ESS it completes), each SACCH's
    MAC_PTT with the slot's talkgroup, source, ALG, KID and MI; decoded
    ``blind`` (no ``p2_params``), the two "recovered" lines at the first
    superframe's SACCH bursts and no voice before the second superframe
    — and nothing else; every AMBE frame's 49 bits through ``spy`` (the
    keyed half decrypted from its second superframe when ``keyed``, the
    ADP key in the keyring; on-air bits otherwise) and 160 PCM samples a
    frame on its slot."""
    n_sym = len(tv["p2_dibits"]) if n_sym is None else n_sym
    wacn, sysid, nac, _key, kid, mi, *ids = (int(v) for v in tv["p2_ids"])
    tg, src = ids[0:2], ids[2:4]
    n_clear = int(tv["p2_halves"][0])
    fpos = tv["p2_frame_pos"]
    whole = fpos + P2_FRAME_DIBITS + POS_TOL <= n_sym
    ev = [e for e in ctx.events if e.protocol == "p25p2"]
    _require(len(ev) == len(ctx.events), "events of another protocol")
    at: dict[int, list] = {}
    for e in ev:
        f = int(np.searchsorted(fpos, e.pos - POS_TOL))
        _require(f < len(fpos) and abs(int(fpos[f]) - e.pos) <= POS_TOL,
                 f"an event off the vector's frames: {e.line!r}@{e.pos}")
        at.setdefault(f, []).append(e)
    recovered = ("       P25p2 scramble parameters recovered from RS "
                 f"parity: WACN [{wacn:05X}] SYSID [{sysid:03X}] "
                 f"NAC [{nac:03X}]")
    got = {"frames": 0, "voice_frames": 0, "decrypted": 0, "ess": 0,
           "ptt": 0, "recovered": 0}
    for f in np.flatnonzero(whole):
        sf, fr = divmod(int(f), 3)
        half = int(sf >= n_clear)
        params = not blind or sf > 0
        want = [("Sync: +P25p2 " + ("" if params else " P2 Missing "
                                    "Parameters            "), {})]
        for k in range(4):
            slot, duid = k % 2, int(tv["p2_frame_duid"][f, k])
            if duid == 3:
                alg = 0xAA if half else 0x80
                if blind and sf == 0:
                    want.append((recovered, {}))
                detail = (f" MAC_PTT\n VCH {slot + 1} - TG {tg[slot]} SRC "
                          f"{src[slot]} ALG {alg:02X} KEY "
                          f"{kid if half else 0:04X}")
                if half:
                    detail += f" MI: 0x{mi:016X}"
                want.append(("       P25p2 SACCH " + detail, {}))
                got["ptt"] += 1
            else:
                detail = ""
                if duid == 6 and params:
                    word = (((0xAA << 16 | kid) << 8 | mi >> 56) << 64
                            | (mi & (1 << 56) - 1) << 8) if half else 0
                    detail = (f"\n ESS_B {word >> 64:08X}"
                              f"{word & (1 << 64) - 1:016X} ERR = 00")
                    got["ess"] += 1
                want.append((f"       P25p2 LCH {slot} "
                             f"{'4V' if duid == 0 else '2V'}{detail}", {}))
            want[-1] = (want[-1][0], {"ts": k, "duid": duid,
                                      "sf_pos": 4 * fr + k})
        have = [(e.line, e.fields) for e in at.get(int(f), [])]
        _require(have == want, (int(f), have, want))
        got["frames"] += 1
        got["recovered"] += sum(w[0] == recovered for w in want)
    v = tv["p2_voice"]
    dec = whole[v[:, 0]] & ((v[:, 3] > 0) | (not blind))
    crypt = keyed & (v[:, 3] > n_clear)
    want = np.where(crypt[:, None],
                    np.unpackbits(tv["p2_voice_clear"], axis=-1)[:, :49],
                    np.unpackbits(tv["p2_voice_onair"], axis=-1)[:, :49])
    n = int(dec.sum())
    _require(len(spy.bits) >= n, (len(spy.bits), n))
    if n:
        np.testing.assert_array_equal(np.stack(spy.bits[:n]), want[dec],
                                      err_msg="P25p2 AMBE bits")
    _require(sum(len(pcm(ctx, s)) for s in (0, 1)) == 160 * len(spy.bits),
             "P25p2 PCM")
    if len(spy.bits) == n:
        for slot in (0, 1):
            _require(len(pcm(ctx, slot))
                     == 160 * int(np.sum(dec & (v[:, 2] == slot))), slot)
    got["voice_frames"] = n
    got["decrypted"] = int(np.sum(crypt & dec))
    return got


# -- one decode, one judge, for any stream ----------------------------------
# the modes whose voice bits are read where they enter the vocoder (each
# AMBE frame's 49 at ``decode_ambe_2450``, YSF's full-rate IMBE 88 at
# ``decode_imbe_4400``) rather than through an ``mbe_sink``; D-STAR's
# frames reach neither and ride in its events' fields
SPIED_MODES = ("x2tdma", "nxdn48", "nxdn96", "dpmr", "ysf", "p25p2")


AUTO_FAMILIES = ("p25p1", "provoice", "dmr", "x2tdma", "nxdn48", "nxdn96",
                 "dpmr", "ysf", "dstar", "m17", "p25p2")


def auto_probe(tv: dict[str, np.ndarray], family: str) -> np.ndarray:
    """The first 4 s of ``family``'s stream at 48 kHz: the probe that
    ``decode_samples(..., "auto")`` is judged on; the JAX package's
    ``detect_mode`` picks are stored beside the streams
    (``auto_families``, ``auto_picks``)."""
    make = {"p25p1": lambda: p25_iq(tv, 4 * 4800),
            "provoice": lambda: pv_iq(tv, 4 * 9600),
            "dmr": lambda: dmr_iq(tv, 4 * 4800),
            "x2tdma": lambda: x2_iq(tv, 4 * 6000),
            "nxdn48": lambda: nxdn_iq(tv, 4 * 2400, "nxdn48"),
            "nxdn96": lambda: nxdn_iq(tv, 4 * 4800, "nxdn96"),
            "dpmr": lambda: dpmr_iq(tv, 4 * 2400),
            "ysf": lambda: ysf_iq(tv, 4 * 4800),
            "dstar": lambda: dstar_iq(tv, 4 * 4800),
            "m17": lambda: m17_iq(tv, 4 * 4800),
            "p25p2": lambda: p2_iq(tv, 4 * 6000)}
    return make[family]()


def auto_pick(tv: dict[str, np.ndarray], family: str) -> str:
    """The JAX ``detect_mode``'s pick on ``family``'s probe."""
    fams = [str(f) for f in tv["auto_families"]]
    return str(tv["auto_picks"][fams.index(family)])


def keyring(tv: dict[str, np.ndarray]) -> KeyRing:
    """The keys of the vector's keyed calls: the P25 ADP key, the DMR
    RC4 key and the P25p2 ADP key (the M17 keys are
    :func:`m17_attrs`)."""
    _n, _tg, _src, key, kid, _seed = (int(v) for v in tv["p25_ids"])
    kr = KeyRing()
    kr.scalar[kid] = key
    kr.scalar[int(tv["dmr_ids"][2])] = int(tv["dmr_ids"][1])
    kr.scalar[int(tv["p2_ids"][4])] = int(tv["p2_ids"][3])
    return kr


def decode_spied(x: np.ndarray, mode: str, **kw):
    """The port's ``decode_samples(x, mode, **kw)`` with the voice bits
    it handed the vocoder kept: (ctx, sinks), the sinks an
    :class:`ImbeSink` for P25, ProVoice and DMR, two :class:`AmbeSpy`
    (AMBE, IMBE) for :data:`SPIED_MODES`, none for D-STAR."""
    from dsdneo_tpu_torch.engine import decoder
    from dsdneo_tpu_torch.vocoder import mbe
    if mode in SPIED_MODES:
        with AmbeSpy(mbe) as ambe, AmbeSpy(mbe, "decode_imbe_4400") as imbe:
            ctx = decoder.decode_samples(x, mode, **kw)
        return ctx, (ambe, imbe)
    if mode == "dstar":
        return decoder.decode_samples(x, mode, **kw), ()
    if mode == "m17":
        udp = UdpSink()
        with M17Spy(m17_decoder.M17Decoder) as spy:
            ctx = decoder.decode_samples(x, mode, m17_udp=udp, **kw)
        return ctx, (spy, udp)
    sink = ImbeSink()
    return decoder.decode_samples(x, mode, mbe_sink=sink, **kw), (sink,)


def judge(mode: str, tv: dict[str, np.ndarray], ctx, sinks,
          n_sym: int | None = None, invert: bool = False,
          keyed: bool = True, blind: bool = False) -> dict[str, int]:
    """Hold a decode of ``mode``'s stream (its first ``n_sym`` symbols)
    to the vector through that mode's judge, with the sinks
    :func:`decode_spied` gave; ``invert`` for an inverted DMR or dPMR
    channel (the DMR one read under ``force_polarity``); ``keyed`` and
    ``blind`` for P25p2 (decoded with the ADP key, without
    ``p2_params``)."""
    if mode == "p25p1":
        return judge_p25(tv, ctx, sinks[0], n_sym)
    if mode == "provoice":
        return judge_pv(tv, ctx, n_sym)
    if mode == "dmr":
        return judge_dmr(tv, ctx, sinks[0], 0, n_sym, invert=invert,
                         rc4=True, bp=True)
    if mode == "x2tdma":
        return judge_x2(tv, ctx, sinks[0], n_sym)
    if mode in NXDN_SPS:
        return judge_nxdn(tv, ctx, sinks[0], mode, n_sym)
    if mode == "dpmr":
        return judge_dpmr(tv, ctx, sinks[0], n_sym, invert)
    if mode == "ysf":
        return judge_ysf(tv, ctx, *sinks, n_sym)
    if mode == "dstar":
        return judge_dstar(tv, ctx, n_sym)
    if mode == "m17":
        return judge_m17(tv, ctx, *sinks, n_sym)
    if mode == "p25p2":
        return judge_p2(tv, ctx, sinks[0], n_sym, keyed, blind)
    raise ValueError(f"no stream of mode {mode!r}")
