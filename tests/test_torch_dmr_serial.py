"""The DMR serial decoder of the PyTorch port against the JAX package's,
on the CPU.

Module parity, bit for bit, on inputs drawn from seeds with numpy:
BPTC(196,96) with 0-3 bit errors, the rate-3/4 trellis (round trip and
errors), RS(12,9) under the LC masks, the CRCs, the AMBE+2 frame ECC
with 0-4 errors, late entry, the short-LC assembler, the UDT decode,
the data header and the PDU assembler.

``DmrBsDecoder.handle`` on the dibit streams made with the burst helpers
of ``tests/test_dmr_data.py`` (the rate-3/4 data call, the embedded-LC
superframe, the reverse channel burst and the MS data burst) through
each package's sync hunt.

``decode_samples`` end to end (``device="cpu"``) on
``engine.dmrbatch.synth_voice_stream(n_superframes=3, seed=11)`` and on
~4 s windows of the ``dmr_*`` stream of ``data/serial_tables.npz``
(upright, inverted, inverted with ``force_polarity``; the RC4 call with
its key in a ``KeyRing``; the Basic Privacy call through
``state_attrs``): every event's line, position, protocol and fields
equal, the AMBE bits through ``mbe_sink`` equal, the port's decode
holding the vector (``engine.serialvec.judge_dmr``), and each slot's PCM
within 2e-3 of the JAX package's peak (the synthesizer sums float32 in
another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")           # the card's machine has none

import test_dmr_data as TD  # noqa: E402
import test_dmr_udt as TU  # noqa: E402
from dsdneo_tpu.crypto.keyring import KeyRing as JKeyRing  # noqa: E402
from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import dmrbatch as jdmrbatch  # noqa: E402
from dsdneo_tpu.fec import bptc as jbptc  # noqa: E402
from dsdneo_tpu.fec import crc as jcrc  # noqa: E402
from dsdneo_tpu.fec import rs as jrs  # noqa: E402
from dsdneo_tpu.fec import trellis34 as jt34  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.dmr import ambe_frame as jaf  # noqa: E402
from dsdneo_tpu.protocol.dmr import data as jdata  # noqa: E402
from dsdneo_tpu.protocol.dmr import late_entry as jle  # noqa: E402
from dsdneo_tpu.protocol.dmr import slc as jslc  # noqa: E402
from dsdneo_tpu.protocol.dmr import udt as judt  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
from dsdneo_tpu_torch.crypto.keyring import KeyRing as TKeyRing  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.fec import bptc as tbptc  # noqa: E402
from dsdneo_tpu_torch.fec import crc as tcrc  # noqa: E402
from dsdneo_tpu_torch.fec import rs as trs  # noqa: E402
from dsdneo_tpu_torch.fec import trellis34 as tt34  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import ambe_frame as taf  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import data as tdata  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import late_entry as tle  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import slc as tslc  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import udt as tudt  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402

DMR_SYM = 4 * 4800                   # 4 s of the DMR stream
PCM_REL = 2e-3


def _flip(bits: np.ndarray, n: int, rng) -> np.ndarray:
    out = np.array(bits, np.uint8)
    idx = rng.choice(len(out), n, replace=False)
    out[idx] ^= 1
    return out


# -- FEC -------------------------------------------------------------------
@pytest.mark.parametrize("n_err", [0, 1, 2, 3])
def test_bptc_196_96(n_err):
    rng = np.random.default_rng(40 + n_err)
    i = np.arange(196, dtype=np.uint8)
    np.testing.assert_array_equal(jbptc.deinterleave_196(i),
                                  tbptc.deinterleave_196(i))
    np.testing.assert_array_equal(jbptc.interleave_196(i),
                                  tbptc.interleave_196(i))
    for _ in range(40):
        msg = rng.integers(0, 2, 96).astype(np.uint8)
        enc = tbptc.bptc_196_96_encode(msg)
        np.testing.assert_array_equal(jbptc.bptc_196_96_encode(msg), enc)
        rx = _flip(enc, n_err, rng)
        a, ea = jbptc.bptc_196_96_decode(rx)
        b, eb = tbptc.bptc_196_96_decode(rx)
        np.testing.assert_array_equal(a, b)
        assert ea == eb
        if n_err <= 1:
            np.testing.assert_array_equal(b, msg)


@pytest.mark.parametrize("n_err", [0, 1, 3, 8])
def test_trellis34(n_err):
    rng = np.random.default_rng(50 + n_err)
    for data in [np.zeros(18, np.uint8), np.full(18, 0xFF, np.uint8)] + [
            rng.integers(0, 256, 18).astype(np.uint8) for _ in range(30)]:
        dib = tt34.encode_r34(data)
        np.testing.assert_array_equal(jt34.encode_r34(data), dib)
        rx = dib.copy()
        idx = rng.choice(98, n_err, replace=False)
        rx[idx] = (rx[idx] + rng.integers(1, 4, n_err)) & 3
        a, ma = jt34.decode_r34(rx)
        b, mb = tt34.decode_r34(rx)
        np.testing.assert_array_equal(a, b)
        assert ma == mb
        if n_err == 0:
            np.testing.assert_array_equal(b, data)
            assert mb == 0


@pytest.mark.parametrize("mask", [0x96, 0x99, 0xA5])
def test_rs_12_9(mask):
    rng = np.random.default_rng(mask)
    j, t = jrs.rs_12_9(), trs.rs_12_9()
    assert j.genpoly == t.genpoly
    for n_err in (0, 1, 2):
        for _ in range(60):
            d = rng.integers(0, 256, 9)
            cw = t.encode(d)
            np.testing.assert_array_equal(j.encode(d), cw)
            cw = cw.copy()
            cw[9:] ^= mask
            pos = rng.choice(12, n_err, replace=False)
            cw[pos] ^= rng.integers(1, 256, n_err)
            cw[9:] ^= 0x96
            a, na = j.decode(cw)
            b, nb = t.decode(cw)
            np.testing.assert_array_equal(a, b)
            assert na == nb


@pytest.mark.parametrize("fn", ["crc16_bits", "crc12_bits", "crc9_bits",
                                "crc8_bits", "crc32_bits"])
def test_crcs(fn):
    rng = np.random.default_rng(len(fn))
    for n in (0, 1, 7, 8, 33, 80, 96, 271, 800):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        assert getattr(jcrc, fn)(bits) == getattr(tcrc, fn)(bits)
        if fn in ("crc9_bits", "crc32_bits"):
            assert getattr(jdata, fn)(bits) == getattr(tdata, fn)(bits)
    bits = np.ones(80, np.uint8)
    assert jcrc.crc16_bits(bits, init=0, xorout=0xFFFF) == tcrc.crc16_bits(
        bits, init=0, xorout=0xFFFF)


@pytest.mark.parametrize("n_err", [0, 1, 2, 3, 4])
def test_ambe_frame(n_err):
    rng = np.random.default_rng(60 + n_err)
    assert jaf.AMBE_MAP == taf.AMBE_MAP
    for _ in range(60):
        b49 = rng.integers(0, 2, 49).astype(np.uint8)
        f72 = taf.encode_ambe_ecc(b49)
        np.testing.assert_array_equal(jaf.encode_ambe_ecc(b49), f72)
        rx = _flip(f72, n_err, rng)
        np.testing.assert_array_equal(jaf.deinterleave_ambe72(rx),
                                      taf.deinterleave_ambe72(rx))
        a, ea = jaf.decode_ambe_ecc(rx)
        b, eb = taf.decode_ambe_ecc(rx)
        np.testing.assert_array_equal(a, b)
        assert ea == eb
        if n_err == 0:
            np.testing.assert_array_equal(b, b49)


@pytest.mark.parametrize("n_err", [0, 2, 6])
def test_late_entry(n_err):
    rng = np.random.default_rng(70 + n_err)
    for mi in [0, 1, 0xFFFFFFFF] + [int(v) for v in
                                    rng.integers(0, 1 << 32, 30)]:
        fr = tle.late_entry_encode(mi)
        np.testing.assert_array_equal(jle.late_entry_encode(mi), fr)
        assert jle.mi_advance32(mi) == tle.mi_advance32(mi)
        fr = fr.copy()
        for _ in range(n_err):
            fr[rng.integers(1, 7), rng.integers(0, 3)] ^= 1 << int(
                rng.integers(0, 4))
        assert jle.late_entry_decode(fr) == tle.late_entry_decode(fr)
        bits = rng.integers(0, 2, 32).astype(np.uint8)
        assert jle.crc4(bits) == tle.crc4(bits)


def test_slc_assembler():
    """The four-fragment C_SYS_PARMS and random short LCs through
    ``tests/test_dmr_udt.py``'s fragment encoder, single fragments, broken
    fragments and every LCSS order, fed to both assemblers."""
    rng = np.random.default_rng(80)
    msgs = []
    for _ in range(150):
        d28 = rng.integers(0, 2, 28).astype(np.uint8)
        slco = int(rng.choice([0, 1, 2, 3, 5, 8, 9, 10, 15]))
        d28[:4] = (slco >> np.arange(3, -1, -1)) & 1
        msgs.append(d28)
    ja, ta = jslc.SlcAssembler(), tslc.SlcAssembler()
    for k, d28 in enumerate(msgs):
        frags = TU._slc_fragments(d28)
        order = [(1, 3, 3, 2), (1, 3, 2, 0), (3, 3, 2, 1), (0, 1, 3, 2)][k % 4]
        for lcss, f in zip(order, frags):
            f = _flip(f, int(rng.integers(0, 3)) * (k % 3 == 1), rng)
            assert ja.feed(lcss, f) == ta.feed(lcss, f)
        p12 = rng.integers(0, 2, 12).astype(np.uint8)
        single = _flip(TU._h17_encode(p12), k % 3, rng)
        assert ja.feed(0, single) == ta.feed(0, single)
        a, b = single.copy(), single.copy()
        assert jslc.hamming17123(a) == tslc.hamming17123(b)
        np.testing.assert_array_equal(a, b)
        d36 = rng.integers(0, 2, 36).astype(np.uint8)
        assert jslc.crc8_dmr(d36, 28) == tslc.crc8_dmr(d36, 28)
        assert jslc.decode_slco(d36) == tslc.decode_slco(d36)


def _udt_cases(rng):
    """(header bits, appended blocks) in the pattern of
    ``tests/test_dmr_udt.py``: every UDT format, 1-4 blocks, random
    payloads, sealed and broken CRCs."""
    for fmt in list(range(12)) + [0x0B, 0x05]:
        uab = int(rng.integers(0, 4))
        hdr = TU.make_udt_header(fmt, int(rng.integers(0, 1 << 24)),
                                 int(rng.integers(0, 1 << 24)),
                                 int(rng.integers(0, 20)), uab)
        app = rng.integers(0, 2, 96 * (uab + 1)).astype(np.uint8)
        if fmt in (3, 4, 7):
            app[: 8 * 10] = np.unpackbits(np.frombuffer(b"HELLO DMR!",
                                                        np.uint8))
        if rng.integers(0, 4):
            app = TU.seal_appended(app)
        yield hdr, [app[96 * i:96 * (i + 1)] for i in range(uab + 1)]


def test_udt_and_pdu_assembler():
    rng = np.random.default_rng(90)
    for hdr, blocks in _udt_cases(rng):
        bits = np.concatenate([hdr] + blocks)
        assert judt.decode_udt(bits, len(blocks)) == tudt.decode_udt(
            bits, len(blocks))
        outs = []
        for m in (jdata, tdata):
            h = m.parse_data_header(hdr)
            asm = m.PduAssembler()
            asm.start(h, header_bits=hdr)
            outs.append([asm.add_block(np.packbits(b)) for b in blocks])
        assert outs[0] == outs[1]
    # the tests' own UDT cases
    for args, app_bits in (((0x04, 1234, 5678, 10, 0), b"HELLO"),
                           ((0x02, 42, 7, 16, 0), None)):
        hdr = TU.make_udt_header(*args)
        app = np.zeros(96, np.uint8)
        if app_bits:
            app[:40] = np.unpackbits(np.frombuffer(app_bits, np.uint8))
        else:
            for i, d in enumerate([9, 1, 1, 11]):
                TU.setb(app, 4 * i, 4, d)
        app = TU.seal_appended(app)
        bits = np.concatenate([hdr, app])
        assert judt.decode_udt(bits, 1) == tudt.decode_udt(bits, 1)


@pytest.mark.parametrize("dpf", [0, 1, 2, 3, 13, 14, 15])
def test_data_header_and_pdu(dpf):
    rng = np.random.default_rng(100 + dpf)
    for k in range(30):
        h = rng.integers(0, 2, 96).astype(np.uint8)
        h[4:8] = (dpf >> np.arange(3, -1, -1)) & 1
        h[65:72] = (int(rng.integers(1, 4)) >> np.arange(6, -1, -1)) & 1
        if dpf == 13:
            h[64:70] = (int(rng.choice([0x12, 0x13, 0x15, 0x16, 0x18, 3]))
                        >> np.arange(5, -1, -1)) & 1
            h[72:80] = 0
        c = jcrc.crc16_bits(h[:80], init=0, xorout=0xFFFF) ^ 0xCCCC
        if k % 5:
            h[80:96] = (c >> np.arange(15, -1, -1)) & 1
        a, b = jdata.parse_data_header(h), tdata.parse_data_header(h)
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.describe() == b.describe()
        assert vars(a) == vars(b)
        outs = []
        for m, hh in ((jdata, a), (tdata, b)):
            asm = m.PduAssembler()
            asm.start(hh, header_bits=h)
            blocks = np.random.default_rng(k).integers(
                0, 256, (max(hh.blocks, 1), 12)).astype(np.uint8)
            if k % 2:
                blocks[0, :6] = [0x45, 0x00, 0x00, 0x24, 0x00, 0x01]
            outs.append([asm.add_block(blk) for blk in blocks])
        assert outs[0] == outs[1]
    for dd in (0x12, 0x13, 0x15, 0x16, 0x17):
        body = np.frombuffer("Grüße".encode("utf-16-be") + b"\0" * 4,
                             np.uint8)
        for pad in (0, 8, 3):
            for ok in (False, True):
                assert jdata.decode_defined_short_data(dd, body, pad, ok) \
                    == tdata.decode_defined_short_data(dd, body, pad, ok)


# -- DmrBsDecoder.handle on the streams of tests/test_dmr_data.py's helpers ---
def _decode_stream(dibits, pkg: str):
    """``tests/test_dmr_data.py``'s ``_decode_stream`` loop (threshold
    0.9) with either package's sync hunt, decoder and context."""
    base, fs = (jbase, jfs) if pkg == "jax" else (tbase, tfs)
    lv = np.array([1.0, 3.0, -1.0, -3.0], dtype=np.float32)
    soft = lv[dibits]
    hits = fs.find_syncs(soft, fs.patterns_for({"dmr"}), threshold=0.9)
    ctx = base.DecoderContext() if pkg == "jax" else base.DecoderContext(
        device="cpu")
    dec = base.registry()["dmr"]()
    for h in hits:
        r = base.DibitReader(dibits, soft, pos=h.end, frame_start=h.pos,
                             invert=h.sync.inverted)
        dec.handle(r, h, ctx)
    return ctx


def _data_call_stream() -> np.ndarray:
    hb = np.zeros(96, dtype=np.uint8)
    hb[0] = 1
    hb[4:8] = [0, 0, 1, 1]
    hb[16:40] = TD._bits_of(100, 24)
    hb[40:64] = TD._bits_of(200, 24)
    hb[65:72] = TD._bits_of(2, 7)
    c = jcrc.crc16_bits(hb[:80], init=0, xorout=0xFFFF) ^ 0xCCCC
    hb[80:96] = TD._bits_of(c, 16)
    payload = np.frombuffer(b"Hello DMR data world over trellis 34",
                            np.uint8)[:32].copy()
    sw = payload.copy()
    sw[0::2], sw[1::2] = payload[1::2], payload[0::2]
    cv = jdata.crc32_bits(np.unpackbits(sw))
    full = np.concatenate([payload, np.packbits(TD._bits_of(cv, 32))])
    gap = np.zeros(80, dtype=np.uint8)
    stream = [gap, TD._make_burst(jbptc.bptc_196_96_encode(hb), 7, 6)]
    for blk in (full[:18], full[18:]):
        dib = jt34.encode_r34(blk)
        p = np.zeros(196, dtype=np.uint8)
        p[0::2], p[1::2] = (dib >> 1) & 1, dib & 1
        stream.append(TD._make_burst(p, 7, 8))
    stream.append(gap)
    return np.concatenate(stream)


def _superframe_stream(flco: int = 0) -> np.ndarray:
    from dsdneo_tpu.fec.blockcodes import qr_16_7_6
    lc = np.zeros(72, dtype=np.uint8)
    lc[2:8] = TD._bits_of(flco, 6)
    lc[16:24] = TD._bits_of(0xC3, 8)
    lc[24:48] = TD._bits_of(4321, 24)
    lc[48:72] = TD._bits_of(8765, 24)
    data77 = np.zeros(77, dtype=np.uint8)
    data77[:72] = lc
    s = sum(int(np.packbits(lc[8 * i:8 * i + 8])[0]) for i in range(9))
    data77[72:77] = TD._bits_of(s % 31, 5)
    frags = TD._bptc_128x77_encode(data77)
    sync_d = TD._sync_dibits("131111333113313313113313")
    qr = qr_16_7_6()
    rng = np.random.default_rng(flco)

    def burst(center_dibits):
        b = rng.integers(0, 4, 144).astype(np.uint8)
        b[66:90] = center_dibits
        return b

    tdma = [np.zeros(80, dtype=np.uint8), burst(sync_d)]
    for k in range(5):
        tdma.append(np.zeros(144, dtype=np.uint8))
        lcss = 1 if k == 0 else (2 if k < 3 else 3)
        emb16 = qr.codebook[(7 << 3) | lcss]
        center = np.zeros(48, dtype=np.uint8)
        center[0:8], center[40:48] = emb16[:8], emb16[8:]
        if k < 4:
            center[8:40] = frags[32 * k:32 * (k + 1)]
        tdma.append(burst(((center[0::2] << 1) | center[1::2]).astype(
            np.uint8)))
    tdma.append(np.zeros(200, dtype=np.uint8))
    return np.concatenate(tdma)


def _rc_stream(cmd: int) -> np.ndarray:
    from dsdneo_tpu.fec.blockcodes import hamming_16_11_4, qr_16_7_6
    from dsdneo_tpu.protocol.dmr.bs import DmrBsDecoder as D
    crc7 = D._crc7_rc(TD._bits_of(cmd, 4))
    row1 = hamming_16_11_4().codebook[(cmd << 7) | (crc7 ^ 0x7A)]
    mat = np.concatenate([row1, 1 - row1])
    inter = mat[D._RC_PLACE[D._RC_DEINT]]
    emb = qr_16_7_6().codebook[(9 << 3)]

    def d(bits):
        return ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)

    gap = np.zeros(40, dtype=np.uint8)
    return np.concatenate([gap, d(inter[:16]), d(emb[:8]),
                           TD._sync_dibits("131331111133133133311313"),
                           d(emb[8:]), d(inter[16:]), gap])


def _ms_data_stream() -> np.ndarray:
    bits = np.zeros(96, dtype=np.uint8)
    bits[0] = 1
    bits[2:8] = TD._bits_of(56, 6)
    c = jcrc.crc16_bits(bits[:80], init=0, xorout=0xFFFF) ^ 0xA5A5
    bits[80:96] = TD._bits_of(c, 16)
    payload = jbptc.bptc_196_96_encode(bits)
    st = TD._golay_slot_type(11, 3)
    sync = TD._sync_dibits("311131133313133331131113")
    sb = np.zeros(48, dtype=np.uint8)
    sb[0::2], sb[1::2] = (sync >> 1) & 1, sync & 1
    bb = np.concatenate([np.zeros(24, dtype=np.uint8), payload[:98], st[:10],
                         sb, st[10:], payload[98:]])
    dd = ((bb[0::2] << 1) | bb[1::2]).astype(np.uint8)
    gap = np.zeros(40, dtype=np.uint8)
    return np.concatenate([gap, dd, gap])


@pytest.mark.parametrize("stream", ["data_call", "superframe",
                                    "superframe_alias", "superframe_gps",
                                    "rc", "ms_data"])
def test_handle_on_the_helper_streams(stream):
    dib = {"data_call": _data_call_stream,
           "superframe": lambda: _superframe_stream(0),
           "superframe_alias": lambda: _superframe_stream(4),
           "superframe_gps": lambda: _superframe_stream(8),
           "rc": lambda: _rc_stream(4),
           "ms_data": _ms_data_stream}[stream]()
    jc, tc = _decode_stream(dib, "jax"), _decode_stream(dib, "torch")
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    text = "\n".join(e.line for e in tc.events)
    want = {"data_call": "CRC32 OK", "superframe": "TGT=4321 SRC=8765",
            "superframe_alias": "Talker Alias LC Header",
            "superframe_gps": "VC6", "rc": "Cease Transmission Command",
            "ms_data": "BS_Dwn_Act"}[stream]
    assert want in text, text


# -- decode_samples end to end ---------------------------------------------
def _keyrings():
    tv = SV.vector()
    key, kid = int(tv["dmr_ids"][1]), int(tv["dmr_ids"][2])
    j, t = JKeyRing(), TKeyRing()
    j.scalar[kid] = key
    t.scalar[kid] = key
    return j, t


def _both(x, mode="dmr", keyring=True, **kw):
    """``decode_samples`` of both packages on ``x``: the events equal, the
    AMBE bits through ``mbe_sink`` equal, each slot's PCM within the
    bound.  Returns (JAX ctx, port ctx, port sink)."""
    jk, tk = _keyrings() if keyring else (None, None)
    js, ts = SV.ImbeSink(), SV.ImbeSink()
    jc = jdec.decode_samples(x, mode, keyring=jk, mbe_sink=js, **kw)
    tc = tdec.decode_samples(x, mode, keyring=tk, mbe_sink=ts,
                             device="cpu", **kw)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    assert len(js.bits) == len(ts.bits) and js.errs == ts.errs
    if js.bits:
        np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))
    assert sorted(jc.audio) == sorted(tc.audio)
    for slot in jc.audio:
        a, b = SV.pcm(jc, slot), SV.pcm(tc, slot)
        assert a.shape == b.shape and b.dtype == np.float32
        if a.size:
            assert np.isfinite(b).all()
            assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    return jc, tc, ts


def test_synth_voice_stream():
    samples, _dib, bits49 = jdmrbatch.synth_voice_stream(n_superframes=3,
                                                         seed=11)
    jc, tc, ts = _both(samples, keyring=False)
    assert sum("VC" in e.line for e in tc.events) >= 30
    assert len(ts.bits) >= 90 and tc.audio


@pytest.mark.parametrize("channel", ["upright", "inverted", "forced"])
def test_dmr_stream(channel):
    """The first 4 s (CSBKs, the data call, the UDT, the short LCs, the
    first calls of both slots with the talker alias and the Basic
    Privacy call, here without its key)."""
    tv = SV.vector()
    invert = channel != "upright"
    attrs = ({"force_polarity": {"dmr": True}} if channel == "forced"
             else None)
    x = SV.dmr_iq(tv, DMR_SYM, invert=invert)
    jc, tc, ts = _both(x, state_attrs=attrs)
    got = SV.judge_dmr(tv, tc, ts, 0, DMR_SYM, invert=invert, rc4=True)
    assert got["superframes"] >= 12 and got["csbks"] >= 10
    assert any("ISO8 Text: HELLO" in e.line for e in tc.events)
    assert any("CRC32 OK" in e.line for e in tc.events)
    assert any(e.line.endswith("Talker Alias: DSD-NEO 15")
               for e in tc.events)


@pytest.mark.parametrize("key", ["keyring", "none"])
def test_dmr_rc4_call(key):
    """The RC4 call (PI header, late-entry MI, the MI refreshed each
    superframe): decrypted with its key in a ``KeyRing``, left as it is
    (and muted) without one."""
    tv = SV.vector()
    start = int(tv["dmr_windows"][0])
    x = SV.dmr_iq(tv, DMR_SYM, start=start)
    jc, tc, ts = _both(x, keyring=key == "keyring")
    got = SV.judge_dmr(tv, tc, ts, start, DMR_SYM, rc4=key == "keyring")
    assert got["rc4_refresh"] >= 4
    if key == "keyring":
        assert got["rc4_frames"] >= 72
    else:
        assert not tc.audio.get(0)


def test_dmr_basic_privacy_call():
    tv = SV.vector()
    start = int(tv["dmr_windows"][1])
    x = SV.dmr_iq(tv, DMR_SYM, start=start)
    attrs = {"dmr_bp_key_id": int(tv["dmr_ids"][4])}
    jc, tc, ts = _both(x, state_attrs=attrs)
    got = SV.judge_dmr(tv, tc, ts, start, DMR_SYM, rc4=True, bp=True)
    assert got["bp_frames"] >= 72


# -- a slot's cipher after its call ends -------------------------------------
def _cipher_then_clear_vector(monkeypatch):
    """A short DMR BS stream from the exporter's ``_dmr_call_vector``: on
    slot 1 an RC4 call (PI header, two superframes, TLC) and after it a
    clear group call (two superframes, TLC); on slot 2 a Basic Privacy
    call."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import export_torch_tables as X

    def programs(_rng):
        calls = []

        def call(slot, tg, src, cipher=0):
            k = len(calls)
            calls.append({"slot": slot, "tg": tg, "src": src, "n_sf": 2,
                          "cipher": cipher, "alias": False})
            lc = X._dmr_lc(0, 0, 0x40 if cipher else 0, tg, src)
            frags = X._dmr_emb_lc128(lc)
            out = [("vlc", lc), ("vlc", lc)]
            if cipher == 2:
                out.append(("pi", 0x21, X.SERIAL_DMR_KID, X.SERIAL_DMR_MI))
            for sf in range(2):
                out += [("voice", k, sf, vc, frags[32 * (vc - 2):
                                                   32 * (vc - 1)]
                         if 2 <= vc <= 5 else None) for vc in range(1, 7)]
            return out + [("tlc", lc)]

        csbk = [("csbk", None)] * 2
        s0 = csbk + call(0, 303, 3003, cipher=2) + csbk \
            + call(0, 404, 4004) + csbk
        s1 = csbk + call(1, 505, 5005, cipher=1)
        return [s0, s1 + [("csbk", None)] * (len(s0) - len(s1))], calls

    n = len(programs(None)[0][0])
    monkeypatch.setattr(X, "_dmr_programs", programs)
    monkeypatch.setattr(X, "SERIAL_DMR_TOTAL",
                        X.SERIAL_DMR_LEAD + 2 * 144 * n + 200)
    return X._dmr_call_vector()


@pytest.mark.parametrize("key", ["keyring", "none"])
def test_slot_cipher_outlives_its_call_in_both(monkeypatch, key):
    """Pins what both packages do with a clear call that follows an RC4
    call on the same slot: ``DmrBsDecoder.crypto[slot]`` is set by the
    PI header and nothing clears it, so the clear call's superframes
    still refresh the RC4 MI, its frames are RC4-"decrypted" where the
    key is held and muted where it is not.  Both packages give the same
    events, voice bits and PCM."""
    tv = _cipher_then_clear_vector(monkeypatch)
    x = SV.dmr_iq(tv)
    jc, tc, ts = _both(x, keyring=key == "keyring")
    lines = [e.line for e in tc.events]
    clear_vlc = next(i for i, s in enumerate(lines)
                     if s.startswith(" Slot 1 - VLC Group TGT=404"))
    clear_tlc = next(i for i, s in enumerate(lines)
                     if s.startswith(" Slot 1 - TLC Group TGT=404"))
    refresh = [s for s in lines[clear_vlc:clear_tlc]
               if s.startswith(" Slot 1 DMR PI C- ALG ID: 21;")]
    assert len(refresh) == 2                   # one a superframe
    cipher = tv["dmr_frame_cipher"]
    onair = np.unpackbits(tv["dmr_ambe_onair"], axis=-1)[:, :49]
    clear = np.flatnonzero(cipher == 0)
    assert len(clear) == 36 and len(ts.bits) == len(cipher)
    got = np.stack(ts.bits)[clear]
    if key == "keyring":
        # the clear frames go through the RC4 keystream
        assert not np.any(np.all(got == onair[clear], axis=1))
        assert len(SV.pcm(tc, 0)) == 160 * 72
    else:
        np.testing.assert_array_equal(got, onair[clear])
        assert not tc.audio.get(0)
