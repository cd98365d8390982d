"""The P25 Phase 1 serial decoder of the PyTorch port against the JAX
package's (``protocol/p25/phase1.py``, ``lcw.py``, ``mbt.py``,
``imbe_frame.py``, ``protocol/dmr/ip_pdu.py``, ``crypto/keystream.py``,
``fec/gf.py``, ``fec/blockcodes.py``, ``fec/rs.py``), on the CPU.  All of
it is numpy in both packages, so everything is held equal, bit for bit:

  - ``decode_lcw`` on the LCWs of ``tests/test_p25_lcw.py`` (recorded by
    running that file's tests with a spy, then replayed in order on
    fresh contexts of both packages) and on 2,000 random LCWs;
    ``decode_mbt`` likewise on ``tests/test_p25_mbt.py``'s MPDUs and
    2,000 random ones; ``decode_ip_pdu`` and ``decode_udp_comp_pdu`` on
    ``tests/test_dmr_ip_pdu.py``'s packets: event lines, fields and the
    context's plain state equal;
  - the frame readers through ``P25P1Decoder.handle`` on the HDU, LDUs
    and TDULC of ``data/serial_tables.npz``, clean, with dibit errors
    and with flipped soft reliabilities, and on MPDUs (an IP data
    packet, an AMBTC, a header with a CRC error);
  - the ADP and DES-OFB keystreams, and the LDU2 encryption-sync
    staging of ``tests/test_crypto_vendor.py:158`` (LDU2's voice under
    the old MI, the new MI after it);
  - the host FEC: GF(2^m) tables, every block code's codebook and ML
    decode of noisy words, the P25 RS codes with errors and erasures,
    the IMBE frame ECC.
"""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

import test_dmr_ip_pdu as IPT  # noqa: E402
import test_p25_lcw as LCWT  # noqa: E402
import test_p25_mbt as MBTT  # noqa: E402
from dsdneo_tpu.crypto import keystream as jks  # noqa: E402
from dsdneo_tpu.fec import blockcodes as jbc  # noqa: E402
from dsdneo_tpu.fec import gf as jgf  # noqa: E402
from dsdneo_tpu.fec import rs as jrs  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.dmr import ip_pdu as jip  # noqa: E402
from dsdneo_tpu.protocol.p25 import imbe_frame as jif  # noqa: E402
from dsdneo_tpu.protocol.p25 import lcw as jlcw  # noqa: E402
from dsdneo_tpu.protocol.p25 import mbt as jmbt  # noqa: E402
from dsdneo_tpu.protocol.p25 import phase1 as jp1  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
from dsdneo_tpu_torch.crypto import keystream as tks  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.fec import blockcodes as tbc  # noqa: E402
from dsdneo_tpu_torch.fec import gf as tgf  # noqa: E402
from dsdneo_tpu_torch.fec import rs as trs  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import ip_pdu as tip  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import imbe_frame as tif  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import lcw as tlcw  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import mbt as tmbt  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import phase1 as tp1  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402

HIT = SimpleNamespace(pos=0, sync=SimpleNamespace(name="+P25p1"))


def _plain_state(ctx) -> dict:
    return {k: v for k, v in vars(ctx.state).items()
            if isinstance(v, (int, float, str, bool, tuple, type(None)))}


def _same(jctx, tctx):
    assert SV.events_equal(jctx.events, tctx.events) is None, \
        SV.events_equal(jctx.events, tctx.events)
    assert _plain_state(jctx) == _plain_state(tctx)


def _record(monkeypatch, module, name):
    """Run every argument-free test of ``module`` with ``module.name``
    spied on; returns the recorded calls' arguments in order."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    for tname, fn in sorted(vars(module).items()):
        if (tname.startswith("test_") and callable(fn)
                and not inspect.signature(fn).parameters):
            fn()
    monkeypatch.undo()
    assert calls, name
    return calls


def _replay(calls, jfn, tfn, ctx_at, dec_at, make_args):
    """Replay recorded calls on fresh contexts and decoders of both
    packages, one pair per distinct context / decoder of the record."""
    jctx, tctx, jdec, tdec = {}, {}, {}, {}
    for args, _kw in calls:
        c = id(args[ctx_at])
        if c not in jctx:
            jctx[c], tctx[c] = jbase.DecoderContext(), tbase.DecoderContext()
        d = args[dec_at]
        if d is not None and id(d) not in jdec:
            jdec[id(d)], tdec[id(d)] = jp1.P25P1Decoder(), tp1.P25P1Decoder()
        jd = None if d is None else jdec[id(d)]
        td = None if d is None else tdec[id(d)]
        jr = jfn(*make_args(args, jctx[c], jd))
        tr = tfn(*make_args(args, tctx[c], td))
        assert jr == tr
        _same(jctx[c], tctx[c])
    return len(calls)


def test_lcw_cases_of_the_jax_tests(monkeypatch):
    calls = _record(monkeypatch, LCWT, "decode_lcw")
    n = _replay(calls, jlcw.decode_lcw, tlcw.decode_lcw, 2, 3,
                lambda a, ctx, dec: (np.asarray(a[0]).copy(), HIT, ctx, dec))
    assert n >= 20


def _random_lcw(rng) -> np.ndarray:
    bits = rng.integers(0, 2, 72).astype(np.uint8)
    lcf = int(rng.integers(0, 256)) & 0x7F if rng.random() < 0.9 \
        else int(rng.integers(0, 256))
    mfid = int(rng.choice([0, 1, 0x90, 0xA4, 0xD8, int(rng.integers(0, 256))]))
    bits[0:8] = [(lcf >> (7 - i)) & 1 for i in range(8)]
    bits[8:16] = [(mfid >> (7 - i)) & 1 for i in range(8)]
    return bits


def test_lcw_random():
    rng = np.random.default_rng(21)
    jctx, tctx = jbase.DecoderContext(), tbase.DecoderContext()
    jd, td = jp1.P25P1Decoder(), tp1.P25P1Decoder()
    for i in range(2000):
        if i % 200 == 0:
            jctx, tctx = jbase.DecoderContext(), tbase.DecoderContext()
        b = _random_lcw(rng)
        jlcw.decode_lcw(b, HIT, jctx, jd)
        tlcw.decode_lcw(b.copy(), HIT, tctx, td)
    _same(jctx, tctx)


def test_mbt_cases_of_the_jax_tests(monkeypatch):
    calls = _record(monkeypatch, MBTT, "decode_mbt")
    n = _replay(calls, jmbt.decode_mbt, tmbt.decode_mbt, 1, 3,
                lambda a, ctx, dec: (np.asarray(a[0]).copy(), ctx, HIT, dec))
    assert n >= 8


def test_mbt_random():
    rng = np.random.default_rng(22)
    jctx, tctx = jbase.DecoderContext(), tbase.DecoderContext()
    jd, td = jp1.P25P1Decoder(), tp1.P25P1Decoder()
    for i in range(2000):
        blocks = int(rng.integers(1, 4))
        fmt = int(rng.choice([0x15, 0x17]))
        m = rng.integers(0, 256, 12 * (1 + blocks)).astype(np.int64)
        m[0] = (m[0] & 0x20) | fmt
        m[1] = int(rng.choice([61, 63]))
        m[2] = int(rng.choice([0, 0x90, int(rng.integers(0, 256))]))
        m[6] = blocks
        m[7 if fmt == 0x17 else 12] = int(rng.integers(0, 64)) | (
            0x80 if rng.random() < 0.1 else 0)
        assert (jmbt.decode_mbt(m, jctx, HIT, jd)
                == tmbt.decode_mbt(m.copy(), tctx, HIT, td))
    _same(jctx, tctx)


@pytest.mark.parametrize("name", ["decode_ip_pdu", "decode_udp_comp_pdu"])
def test_ip_pdu_cases_of_the_jax_tests(monkeypatch, name):
    calls = _record(monkeypatch, IPT, name)
    for args, kw in calls:
        a = [np.asarray(x).copy() if isinstance(x, np.ndarray) else x
             for x in args]
        assert getattr(jip, name)(*args, **kw) == getattr(tip, name)(*a, **kw)


def test_mpdu_data_sap_cases():
    """``P25P1Decoder._mpdu_data_sap`` on the SAPs of
    ``tests/test_p25_mbt.py``'s routing test and on random bodies."""
    rng = np.random.default_rng(23)
    jd, td = jp1.P25P1Decoder(), tp1.P25P1Decoder()
    jctx, tctx = jbase.DecoderContext(), tbase.DecoderContext()
    ip = np.zeros(20, np.uint8)
    ip[0], ip[3], ip[9] = 0x45, 28, 0x11
    udp = np.array([0x0F, 0xA7, 0x0F, 0xA8, 0, 8, 0, 0], np.uint8)
    sent = b"$GPGLL,4530.00,N,11215.00,W*"
    csum = 0
    for c in sent[1:-1]:
        csum ^= c
    nmea = np.frombuffer(sent + f"{csum:02X}".encode() + b"\0\0\0\0",
                         np.uint8)
    cases = [(0, np.concatenate([ip, udp, np.zeros(4, np.uint8)])),
             (6, np.array([5, 0, 0, 0, 0], np.uint8)), (48, nmea),
             (48, np.frombuffer(b"Hello loc\0\0\0\0", np.uint8))]
    for _ in range(300):
        cases.append((int(rng.choice([0, 4, 6, 32, 34, 48, 7])),
                      rng.integers(0, 256, int(rng.integers(1, 60))
                                   ).astype(np.uint8)))
    for sap, payload in cases:
        hdr = rng.integers(0, 256, 12).astype(np.int64)
        hdr[9] &= int(rng.choice([0, 3]))
        io, pad = int(rng.integers(0, 2)), int(rng.integers(0, 4))
        assert (jd._mpdu_data_sap(sap, payload, hdr, io, pad, jctx, HIT)
                == td._mpdu_data_sap(sap, payload.copy(), hdr.copy(), io,
                                     pad, tctx, HIT))


def _handle_both(dibits, soft, sync_name="+P25p1", state=None):
    """``P25P1Decoder.handle`` of both packages at a frame whose sync
    starts at 0; returns the two contexts."""
    out = []
    for fs, base, p1 in ((jfs, jbase, jp1), (tfs, tbase, tp1)):
        sd = next(d for d in fs.SYNC_DEFS if d.name == sync_name)
        hit = fs.SyncHit(pos=0, score=1.0, sync=sd)
        ctx = base.DecoderContext(**({} if base is jbase
                                     else {"device": "cpu"}))
        for k, v in (state or {}).items():
            setattr(ctx.state, k, v)
        r = base.DibitReader(dibits.copy(), soft.copy(), pos=hit.end,
                             frame_start=0, invert=sd.inverted)
        end = p1.P25P1Decoder().handle(r, hit, ctx)
        out.append((ctx, end, list(r.status_dibits)))
    (jc, je, js), (tc, te, ts) = out
    assert (je, js) == (te, ts)
    _same(jc, tc)
    np.testing.assert_array_equal(SV.pcm(jc).shape, SV.pcm(tc).shape)
    return jc, tc


def _frame(tv, start, n=900):
    return tv["p25_dibits"][start:start + n].copy()


@pytest.mark.parametrize("which", ["hdu", "ldu1", "ldu2", "tdulc"])
@pytest.mark.parametrize("noise", ["clean", "errors", "soft"])
def test_frame_readers(which, noise):
    tv = SV.vector()
    start = {"hdu": int(tv["p25_hdu_pos"]),
             "ldu1": int(tv["p25_ldu_pos"][2]),
             "ldu2": int(tv["p25_ldu_pos"][3]),
             "tdulc": int(tv["p25_tdulc_pos"])}[which]
    d = _frame(tv, start)
    rng = np.random.default_rng(hash((which, noise)) & 0xFFFF)
    soft = np.where(d & 2, -1.0, 1.0) * np.where(d & 1, 3.0, 1.0)
    soft = (soft + rng.normal(0, 0.3, len(d))).astype(np.float32)
    if noise == "errors":
        idx = rng.choice(np.arange(60, len(d)), 12, replace=False)
        d[idx] ^= rng.integers(1, 4, 12).astype(np.uint8)
    elif noise == "soft":
        idx = rng.choice(np.arange(60, len(d)), 40, replace=False)
        soft[idx] *= 0.05
    state = None
    if which in ("ldu1", "ldu2"):
        # keyed: the superframe's voice decrypts (both packages' key
        # rings answer ``lookup`` alike)
        state = {"payload_algid": 0xAA, "payload_kid": 0x42,
                 "payload_mi": 0x1122334455667788 << 8,
                 "keyring": tks_keyring()}
    jc, tc = _handle_both(d, soft, state=state)
    if which in ("ldu1", "ldu2"):
        assert len(SV.pcm(tc)) == 9 * 160
    assert tc.events[0].line.startswith("Sync: +P25p1")
    if noise == "clean":
        assert all("ERR" not in e.line for e in tc.events)


def tks_keyring():
    from dsdneo_tpu_torch.crypto.keyring import KeyRing
    kr = KeyRing()
    kr.scalar[0x42] = 0x0123456789
    return kr


def test_inverted_frame_reader():
    tv = SV.vector()
    d = _frame(tv, int(tv["p25_ldu_pos"][0]))
    d ^= 2
    soft = -(np.where(d & 2, -1.0, 1.0) * np.where(d & 1, 3.0, 1.0))
    jc, tc = _handle_both(d, soft.astype(np.float32), "-P25p1")
    assert tc.events[0].line.startswith("Sync: -P25p1")


def _mpdu_dibits(blocks96) -> np.ndarray:
    from dsdneo_tpu.fec import trellis
    from dsdneo_tpu.protocol.p25 import encode as E
    data = [E.nid_dibits(0x293, 0xC)]
    for b in blocks96:
        c = trellis.p25_12_encode(np.asarray(b, np.uint8))
        data.append(((c[0::2] << 1) | c[1::2]).astype(np.uint8))
    body = E._with_status(np.concatenate(data), start=24)
    return np.concatenate([E.SYNC_DIBITS, body,
                           np.zeros(120, np.uint8)])


def _crc_block(octets) -> np.ndarray:
    from dsdneo_tpu.fec import crc
    bits = np.unpackbits(np.asarray(octets, np.uint8))[:80]
    c = crc.crc16_bits(bits, init=0, xorout=0xFFFF)
    return np.concatenate([bits, [(c >> (15 - i)) & 1 for i in range(16)]]
                          ).astype(np.uint8)


@pytest.mark.parametrize("kind", ["ip", "ambtc", "bad_crc", "tsbk_sap"])
def test_mpdu_path(kind):
    rng = np.random.default_rng(24)
    blocks = 2
    hdr = np.zeros(10, np.int64)
    if kind == "ambtc":
        hdr[0], hdr[1], hdr[6], hdr[7] = 0x20 | 0x17, 61, blocks, 0x00
    elif kind == "tsbk_sap":
        hdr[0], hdr[1], hdr[6] = 0x20 | 0x16, 61, blocks
    else:
        hdr[0], hdr[1], hdr[6] = 0x20 | 0x16, 0, blocks
    h = _crc_block(hdr)
    if kind == "bad_crc":
        h[90] ^= 1
    ip = np.zeros(20, np.uint8)
    ip[0], ip[3], ip[9] = 0x45, 28, 0x11
    pay = np.concatenate([ip, [0x0F, 0xA7, 0x0F, 0xA8, 0, 8, 0, 0],
                          np.zeros(4, np.uint8)]).astype(np.uint8)
    if kind == "ambtc":
        pay = rng.integers(0, 256, 24).astype(np.uint8)
    body = [np.unpackbits(pay[12 * i:12 * i + 12]) for i in range(blocks)]
    if kind == "tsbk_sap":
        body = [_crc_block(rng.integers(0, 256, 10)) for _ in range(blocks)]
    d = _mpdu_dibits([h] + body)
    soft = (np.where(d & 2, -1.0, 1.0) * np.where(d & 1, 3.0, 1.0)
            ).astype(np.float32)
    jc, tc = _handle_both(d, soft)
    assert len(tc.events) >= 2 or kind == "bad_crc"


def test_adp_and_des_ofb_keystreams():
    rng = np.random.default_rng(25)
    for _ in range(20):
        key = int(rng.integers(0, 1 << 40))
        mi = int(rng.integers(0, 1 << 62)) << 8
        n, drop = int(rng.integers(1, 300)), int(rng.integers(0, 600))
        np.testing.assert_array_equal(
            jks.p25_adp_keystream(key, mi, n, drop=drop),
            tks.p25_adp_keystream(key, mi, n, drop=drop))
        k64, iv = (int(v) for v in rng.integers(0, 1 << 62, 2))
        np.testing.assert_array_equal(jks.des_ofb_keystream(k64, iv, 40),
                                      tks.des_ofb_keystream(k64, iv, 40))
        assert (jks.des_encrypt_block(iv, k64)
                == tks.des_encrypt_block(iv, k64))
    np.testing.assert_array_equal(jks.rc4_keystream(b"\x01\x02", 64, 7),
                                  tks.rc4_keystream(b"\x01\x02", 64, 7))


@pytest.mark.parametrize("algid", [0xAA, 0x81])
def test_decrypt_imbe(algid):
    """``_decrypt_imbe`` through a superframe's offsets (``_voice``'s +2
    before frame 8), ADP and DES-OFB."""
    out = []
    for base, p1 in ((jbase, jp1), (tbase, tp1)):
        kr = tks_keyring()
        ctx = base.DecoderContext()
        ctx.state.keyring = kr
        ctx.state.payload_algid, ctx.state.payload_kid = algid, 0x42
        ctx.state.payload_mi, ctx.state.ks_offset = 0xAB12CD34EF5678 << 16, 0
        r = np.random.default_rng(27)
        got = []
        for i in range(18):
            if i % 9 == 8:
                ctx.state.ks_offset += 2
            got.append(p1.P25P1Decoder()._decrypt_imbe(
                r.integers(0, 2, 88).astype(np.uint8), ctx))
        out.append((np.stack(got), ctx.state.ks_offset,
                    ctx.state.p25_enc_unbroken))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_ldu2_ess_staged_until_after_voice():
    """``tests/test_crypto_vendor.py:158`` in both packages: LDU2's voice
    decrypts under the old MI; the new MI and the offset reset apply
    after it."""
    from dsdneo_tpu.crypto.keystream import rc4_keystream
    from dsdneo_tpu.vocoder.imbe import B0_HI_POS
    key, kid = 0x0123456789, 0x0042
    mi_old, mi_new = 0xAABBCCDDEEFF112200, 0x99887766554433 << 16
    rng = np.random.default_rng(7)
    ks = rc4_keystream(key.to_bytes(5, "big")
                       + (mi_old >> 8).to_bytes(8, "big"), 267 + 9 * 11 + 2)
    frames, enc = [], []
    for i in range(9):
        off = 267 + 11 * i + (2 if i == 8 else 0)
        pt = rng.integers(0, 2, 88).astype(np.uint8)
        pt[B0_HI_POS[0]] = 0
        frames.append(pt)
        enc.append(jif.encode_imbe_ecc(pt ^ np.unpackbits(ks[off:off + 11])))
    es = np.concatenate([[(mi_new >> (71 - j)) & 1 for j in range(72)],
                         [(0xAA >> (7 - j)) & 1 for j in range(8)],
                         [(kid >> (15 - j)) & 1 for j in range(16)]])
    word = jrs.rs_24_16_9().encode(
        (es.reshape(16, 6) << np.arange(5, -1, -1)).sum(1))
    ham = jbc.hamming_10_6_3()
    bits = []
    w = 0
    for seg in range(9):
        bits.append(enc[seg])
        if 1 <= seg <= 6:
            for _ in range(4):
                bits.append(ham.encode(int(word[w])))
                w += 1
        elif seg == 7:
            bits.append(np.zeros(32, np.uint8))
    b = np.concatenate(bits)
    d = np.zeros(900, np.uint8)
    d[:len(b) // 2] = (b[0::2] << 1) | b[1::2]
    res = []
    for base, p1 in ((jbase, jp1), (tbase, tp1)):
        kr = tks_keyring()
        ctx = (base.DecoderContext() if base is jbase
               else base.DecoderContext(device="cpu"))
        kr.scalar[kid] = key
        ctx.state.keyring = kr
        ctx.state.payload_algid, ctx.state.payload_kid = 0xAA, kid
        ctx.state.payload_mi, ctx.state.ks_offset = mi_old, 0
        sink = SV.ImbeSink()
        ctx.mbe_sink = sink
        r = base.DibitReader(d, np.zeros(900, np.float32), pos=0)
        p1.P25P1Decoder()._ldu2(r, HIT, ctx)
        np.testing.assert_array_equal(np.stack(sink.bits), np.stack(frames))
        res.append((ctx.state.payload_mi, ctx.state.ks_offset,
                    [e.line for e in ctx.events]))
    assert res[0] == res[1] and res[0][:2] == (mi_new, 0)


def test_gf_tables():
    for m in (4, 6, 8):
        a, b = jgf.GF2m(m), tgf.GF2m(m)
        np.testing.assert_array_equal(a.exp_table, b.exp_table)
        np.testing.assert_array_equal(a.log_table, b.log_table)
    for m, t in ((6, 4), (6, 22), (5, 6)):
        assert jgf.bch_generator_poly(m, t) == tgf.bch_generator_poly(m, t)


BLOCK_CODES = ["bch_63_16", "golay_24_12", "golay_20_8", "golay_18_6_8",
               "hamming_7_4", "hamming_12_8", "hamming_13_9",
               "hamming_15_11", "hamming_16_11_4", "hamming_10_6_3",
               "qr_16_7_6"]


@pytest.mark.parametrize("name", BLOCK_CODES)
def test_block_codes(name):
    a, b = getattr(jbc, name)(), getattr(tbc, name)()
    np.testing.assert_array_equal(a.codebook, b.codebook)
    assert (a.n, a.k) == (b.n, b.k)
    rng = np.random.default_rng(28)
    for _ in range(60 if name == "bch_63_16" else 300):
        m = int(rng.integers(0, 1 << a.k))
        w = a.encode(m).copy()
        w[rng.integers(0, a.n, 3)] ^= 1
        rel = rng.uniform(0, 3, a.n).astype(np.float32)
        assert a.decode(w, rel) == b.decode(w.copy(), rel.copy())
        assert a.decode(w) == b.decode(w.copy())


@pytest.mark.parametrize("code", ["rs_24_12_13", "rs_24_16_9", "rs_36_20_17"])
def test_p25_rs_codes(code):
    a, b = getattr(jrs, code)(), getattr(trs, code)()
    assert a.genpoly == b.genpoly
    rng = np.random.default_rng(29)
    for _ in range(200):
        data = rng.integers(0, 64, a.k)
        cw = a.encode(data)
        np.testing.assert_array_equal(cw, b.encode(data))
        r = cw.copy()
        ne = int(rng.integers(0, a.nroots // 2 + 3))
        pos = rng.choice(a.n, ne, replace=False)
        r[pos] ^= rng.integers(1, 64, ne)
        eras = ([int(p) for p in rng.choice(a.n, 3, replace=False)]
                if rng.random() < 0.5 else None)
        ja, jn = a.decode(r, erasures=eras)
        ta, tn = b.decode(r.copy(), erasures=eras)
        assert jn == tn
        np.testing.assert_array_equal(ja, ta)


def test_imbe_frame_ecc():
    rng = np.random.default_rng(30)
    for _ in range(300):
        b88 = rng.integers(0, 2, 88).astype(np.uint8)
        f = jif.encode_imbe_ecc(b88)
        np.testing.assert_array_equal(f, tif.encode_imbe_ecc(b88))
        f = f.copy()
        f[rng.integers(0, 144, int(rng.integers(0, 8)))] ^= 1
        ja, je = jif.decode_imbe_ecc(f)
        ta, te = tif.decode_imbe_ecc(f.copy())
        assert je == te
        np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jif._pn_bits(0x5A5, 114),
                                  tif._pn_bits(0x5A5, 114))
