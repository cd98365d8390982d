"""The P25 Phase 2 TDMA control-channel monitor of the PyTorch port
against the JAX package's, on the CPU, piece by piece and whole:

  - the RS(63,35) erasure decode (``fec.rs.ReedSolomon.decode`` with
    the SACCH and FACCH layouts' erasures) on seeded words with 0-16
    symbol errors: the same word and count, -1 included;
  - the screen's tables: the GF(2) map of the systematic RS(63,35)
    encode of both kinds, the CRC12 contribution tables (168 and 144
    bits), the 128 ISCH codewords;
  - ``xcch_rs_decode`` on errored bursts and the blind recovery of the
    scramble seed (``recover_scramble_seed``) on lists of them;
  - the MAC catalog (``P2MacWalker``): the cases of
    ``tests/test_p2_mac.py`` and a seeded sweep of 2,400 PDUs over every
    opcode ``mac_msg_len`` knows, MFIDs 0x00, 0x90, 0xA4, 0xD8 and
    others, and multi-fragment sequences: the walk's text, every event
    (line and fields) and the context's state after every PDU;
  - ``P25P2Decoder._xcch`` on clean, errored, scrambled, unscrambled,
    LCCH and relaxed-CRC bursts and on the blind recovery;
  - the control-stream generator and its modulator against the JAX
    package's ``encode`` and ``_cc_iq`` of ``tests/test_p2ccbatch.py``;
  - ``p2_xcch_gather_device`` byte for byte;
  - ``BatchedP2ControlPipeline(device="cpu")`` against the JAX pipeline
    on 3 channels (leads 0/47/96) over two blocks with the contexts
    kept, the parse cache on and off, with the parameters given and
    recovered blind, on the errored-burst blocks of
    ``test_p2ccbatch.py`` and on the bench's 6-superframe block: the
    events line for line and field for field, the PDUs parsed,
    ``rs_fallbacks`` and ``crc_errors``.  The JAX package keeps the top
    64 sync candidates of a channel and the port 128, so the blocks'
    matches above the threshold are counted and pinned (at most 64).

Every comparison is exact.  The JAX functions are jitted, as its
pipeline calls them.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")     # the card's machine has none

from dsdneo_tpu.engine import ccbatch as J
from dsdneo_tpu.fec import rs as jrs
from dsdneo_tpu.protocol.base import DecoderContext as JCtx
from dsdneo_tpu.protocol.p25 import encode as jenc, p2_xcch as jx
from dsdneo_tpu.protocol.p25.p2_mac import P2MacWalker as JWalker
from dsdneo_tpu.protocol.p25.phase1 import P25P1Decoder as JP1
from dsdneo_tpu.protocol.p25.phase2 import P25P2Decoder as JP2
from dsdneo_tpu.symbols import framesync as jfs
from dsdneo_tpu_torch.engine import ccbatch as P
from dsdneo_tpu_torch.fec import rs as trs
from dsdneo_tpu_torch.protocol.base import DecoderContext as TCtx
from dsdneo_tpu_torch.protocol.p25 import encode as tenc, p2_xcch as tx
from dsdneo_tpu_torch.protocol.p25.mac_tables import (_HARRIS, _MOTOROLA,
                                                      _STANDARD, _TAIT)
from dsdneo_tpu_torch.protocol.p25.p2_mac import _MULTIFRAG_BASES
from dsdneo_tpu_torch.protocol.p25.p2_mac import P2MacWalker as TWalker
from dsdneo_tpu_torch.protocol.p25.phase1 import P25P1Decoder as TP1
from dsdneo_tpu_torch.protocol.p25.phase2 import P25P2Decoder as TP2
from dsdneo_tpu_torch.symbols import framesync as tfs

from test_p2ccbatch import (CENTER, GRANT_CH, NAC, SYSID, TG, WACN, _cc_iq,
                            _default_msgs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPS = 8
LEADS = (0, 47, 96)
SEEDS = ((0, 3, 0), (3, 0, 3))      # per block, per channel


def _hits(pos):
    """The same sync hit in both packages."""
    return (jfs.SyncHit(pos, 1.0, next(d for d in jfs.SYNC_DEFS
                                       if d.name == "+P25p2")),
            tfs.SyncHit(pos, 1.0, next(d for d in tfs.SYNC_DEFS
                                       if d.name == "+P25p2")))


def _norm(v):
    """A context's state as plain values (the registries by content)."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, set):
        return sorted(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "__dict__"):
        return (type(v).__name__, _norm(vars(v)))
    return v


def _events(ctx):
    return [(e.line, e.protocol, e.pos, e.fields) for e in ctx.events]


def assert_ctx_equal(a, b):
    assert _events(a) == _events(b)
    assert _norm(vars(a.state)) == _norm(vars(b.state))


def _msgs(enc):
    """``_default_msgs`` of ``test_p2ccbatch.py`` built by ``enc``."""
    def msgs(sf, g):
        if g % 4 == 1:
            return [enc.p2_mac_iden_up_tdma(1, CENTER, 6250.0)]
        if g % 4 == 2:
            return [enc.p2_mac_group_grant(GRANT_CH, TG, 5555)]
        return [enc.p2_mac_net_sts(WACN, SYSID)]
    return msgs


# -- the RS(63,35) erasure decode -------------------------------------------------
def _rs_words(kind: str, n_err: int, n_words: int = 3):
    """Received xCCH words: a codeword of random payload hexbits, the
    symbols the layout does not transmit zeroed, ``n_err`` random symbol
    errors at transmitted positions."""
    j0, np_hex, _npar, eras = jx._LAYOUT[kind]
    rng = np.random.default_rng(1000 * n_err + (kind == "facch"))
    code = jrs.rs_63_35()
    sent = [p for p in range(63) if p not in eras]
    out = []
    for _ in range(n_words):
        data = np.zeros(35, np.int64)
        data[j0:j0 + np_hex] = rng.integers(0, 64, np_hex)
        vec = code.encode(data).astype(np.int64)
        vec[eras] = 0
        pos = rng.choice(sent, n_err, replace=False)
        vec[pos] ^= rng.integers(1, 64, n_err)
        out.append(vec)
    return out


@pytest.mark.parametrize("kind", ["sacch", "facch"])
@pytest.mark.parametrize("n_err", range(17))
def test_rs_erasure_decode_matches_jax(kind, n_err):
    eras = jx._LAYOUT[kind][3]
    for vec in _rs_words(kind, n_err):
        want, wn = jrs.rs_63_35().decode(vec, erasures=eras)
        got, gn = trs.rs_63_35().decode(vec, erasures=eras)
        assert gn == wn
        np.testing.assert_array_equal(got, want)
        if n_err == 0:
            assert gn >= 0
    # the call form without erasures stays the decoder it was
    want, wn = jrs.rs_63_35().decode(vec)
    got, gn = trs.rs_63_35().decode(vec)
    assert gn == wn
    np.testing.assert_array_equal(got, want)


# -- the screen's tables -------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sacch", "facch"])
def test_xcch_encode_matrix_matches_jax(kind):
    got = tx.xcch_encode_matrix(kind)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jx.xcch_encode_matrix(kind))


@pytest.mark.parametrize("n", [168, 144])
def test_crc12_matrix_matches_jax(n):
    got = tx.crc12_matrix(n)
    assert got.shape == (n, 12) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jx.crc12_matrix(n))
    rng = np.random.default_rng(n)
    for _ in range(8):
        bits = rng.integers(0, 2, n + 12).astype(np.uint8)
        assert tx.crc12_of(bits, n) == jx.crc12_of(bits, n)
        assert tx.crc12_ok(bits, n) == jx.crc12_ok(bits, n)
        bits[n:] = [(jx.crc12_of(bits, n) >> (11 - j)) & 1 for j in range(12)]
        assert tx.crc12_ok(bits, n) and jx.crc12_ok(bits, n)


def test_isch_codewords_match_jax():
    assert [tx.isch_codeword(v) for v in range(128)] == \
        [jx.isch_codeword(v) for v in range(128)]
    assert tx.ISCH_SYNC == jx.ISCH_SYNC


# -- xCCH decode and the blind recovery ----------------------------------------------
def _burst(kind, rng, key, p, n_flip=0):
    """A scrambled xCCH timeslot (DUID 3 or 9) of a random MAC payload at
    superframe position ``p``, ``n_flip`` payload or parity bits
    flipped."""
    nbits = 180 if kind == "sacch" else 156
    payload = jenc.p2_mac_payload(
        3, [rng.integers(0, 256, nbits // 8 - 3).tolist()], kind)
    scr = jx.generate_scramble_bits(*key, 4340)
    ts = jenc.p2_xcch_ts(payload, 3 if kind == "sacch" else 9, p,
                         scramble=scr)
    data = np.r_[2:74, 76:318]
    ts[rng.choice(data, n_flip, replace=False)] ^= 1
    return ts


@pytest.mark.parametrize("kind", ["sacch", "facch"])
@pytest.mark.parametrize("n_flip", [0, 3, 12, 30, 60])
def test_xcch_rs_decode_matches_jax(kind, n_flip):
    rng = np.random.default_rng(7 + n_flip)
    ex = jx.extract_sacch if kind == "sacch" else jx.extract_facch
    tex = tx.extract_sacch if kind == "sacch" else tx.extract_facch
    for _ in range(4):
        ts = _burst(kind, rng, (0, 0, 0), 0, n_flip)
        pl, pr = ex(ts)
        tpl, tpr = tex(ts)
        np.testing.assert_array_equal(tpl, pl)
        np.testing.assert_array_equal(tpr, pr)
        want, wn = jx.xcch_rs_decode(pl, pr, kind)
        got, gn = tx.xcch_rs_decode(tpl, tpr, kind)
        assert gn == wn
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tx.xcch_rs_encode(pl, kind),
                                      jx.xcch_rs_encode(pl, kind))
        a, b = np.zeros(360, np.uint8), np.zeros(360, np.uint8)
        (jx.insert_sacch if kind == "sacch" else jx.insert_facch)(a, pl, pr)
        (tx.insert_sacch if kind == "sacch" else tx.insert_facch)(b, pl, pr)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sacch", "facch"])
@pytest.mark.parametrize("case", ["clean", "first_corrupt", "all_corrupt",
                                  "mixed_kinds"])
def test_recover_scramble_seed_matches_jax(kind, case):
    rng = np.random.default_rng({"clean": 1, "first_corrupt": 2,
                                 "all_corrupt": 3, "mixed_kinds": 4}[case])
    key = (int(rng.integers(1, 1 << 20)), int(rng.integers(1, 1 << 12)),
           int(rng.integers(1, 1 << 12)))
    pos = rng.integers(0, 12, 4).tolist()
    flips = {"clean": [0, 0, 0, 0], "first_corrupt": [40, 0, 0, 0],
             "all_corrupt": [40, 40, 40, 40], "mixed_kinds": [0, 2, 0, 0]}[case]
    kinds = [kind] * 4 if case != "mixed_kinds" else [
        kind, "sacch", "facch", kind]
    bursts = [(_burst(k, rng, key, p, f), p, k)
              for k, p, f in zip(kinds, pos, flips)]
    want = jx.recover_scramble_seed(bursts)
    got = tx.recover_scramble_seed(bursts)
    assert got == want
    assert (want == key) if case != "all_corrupt" else want is None
    for p in set(pos):
        np.testing.assert_array_equal(tx._seed_matrix(p, kind),
                                      jx._seed_matrix(p, kind))


# -- the MAC catalog -----------------------------------------------------------------
def _suid(wacn, sysid):
    return [(wacn >> 12) & 0xFF, (wacn >> 4) & 0xFF,
            ((wacn & 0xF) << 4) | (sysid >> 8), sysid & 0xFF]


def _bsi(text):
    packed = 0
    for v in [ord(c) - 43 for c in text] + [0, 0]:
        packed = (packed << 6) | v
    return [(packed >> (8 * (5 - i))) & 0xFF for i in range(6)]


_FRAG = [20, 0x00, 0x22, 0x33] + _suid(0x92065, 0x0D5) + [
    0x00, 0x22, 0x33, 0x00, 0x44, 0x55, 0x00]
# the cases of tests/test_p2_mac.py: name → PDUs walked in turn on one
# walker and context, each a list of messages
MAC_CASES = {
    "explicit_group_grant_c0": [[[0xC0, 0x00, 0x10, 0x0A, 0x10, 0x0B,
                                  1234 >> 8, 1234 & 0xFF, 0x08, 0xAA,
                                  0x52]]],
    "uu_grant_extended_suid": [[[0xC4, 0x10, 0x0A, 0x10, 0x0B]
                                + _suid(0xBEE00, 0x14C)
                                + [0x01, 0x02, 0x03, 0x0A, 0x0B, 0x0C]]],
    "mfid90_regroup_grant_implicit": [[[0xA3, 0x90, 0x0B, 0x00, 0x21, 0x14,
                                        0x00, 0x38, 0x00, 0x12, 0x34]]],
    "motorola_deny_response": [[[0xA7, 0x90, 0x0B, 0x80, 0x60, 0x00, 0x00,
                                 0x01, 0x00, 0x30, 0x39]]],
    "motorola_bsi_callsign": [[[0x85, 0x90, 0x09] + _bsi("WA7DSD")]],
    "harris_uu_data_grant": [[[0xAC, 0xA4, 0x0C, 0x00, 0x10, 0x0A, 0x00,
                               0x00, 0x07, 0x00, 0x00, 0x09]]],
    "tait_micro_slot_counter": [[[0xB5, 0xD8, 0x05, 0xAB, 0xCD]]],
    "multifrag_call_alert": [[[0xCB, 0x00] + _FRAG[:16]],
                             [[0x10, 0x06] + _FRAG[16:20]]],
    "multifrag_cleared": [[[0xCB, 0x00, 30] + [0] * 15],
                          [[0x40, 0, 0x10, 0x0A, 0, 5, 0, 0, 1]],
                          [[0x10, 0x06, 1, 2, 3, 4]]],
    "multiple_messages_one_pdu": [[[0x40, 0x00, 0x10, 0x0A, 0x00, 0x38,
                                    0x00, 0x12, 0x34],
                                   [0x5F, 0x00, 0x00, 0x07, 0x00, 0x00,
                                    0x09]]],
    "tsbk_bridge_network_status": [[[0x7B, 0x00] + _suid(0x92065, 0x0D5)
                                    + [0x21, 0x14, 0, 0, 0]]],
    "status_update_extended_vch": [[[0xD8, 0x00, 0x11, 0x22, 0x00, 0x00,
                                     0x05] + _suid(0xBEE00, 0x14C)
                                    + [0x00, 0x00, 0x09]]],
    "extended_function_radio_inhibit": [[[0xE5, 0x00, 0x00, 0x7D, 0x00,
                                          0x00, 0x00, 0x00, 0x00, 0x07,
                                          0x01, 0x02, 0x03, 0x04]]],
    "harris_gps_location": [[[0xAA, 0xA4, 0x11, 0, 0, 30, 33, 0, 0, 0x8F,
                              112, 0xB0, 0xF0, 0, 0, 90]]],
    "harris_talker_alias": [[[0xA8, 0xA4, 3 + 8] + list(b"LADDER 7")]],
}


def _mac(msgs, n_oct=22):
    mac = np.zeros(24, dtype=np.int64)
    i = 1
    for m in msgs:
        mac[i:i + len(m)] = m[:max(0, 24 - i)]
        i += len(m)
    return mac


class _Pair:
    """One walker and context in each package, fed the same PDUs."""

    def __init__(self):
        self.w = (JWalker(JP1), TWalker(TP1))
        self.ctx = (JCtx(), TCtx())

    def walk(self, mac, n_oct, slot, pos):
        out = []
        for w, ctx, hit in zip(self.w, self.ctx, _hits(pos)):
            try:
                out.append(w.walk(mac, n_oct, slot, ctx, hit))
            except Exception as e:                    # noqa: BLE001
                out.append(f"raised {type(e).__name__}: {e}")
        assert out[1] == out[0]
        assert_ctx_equal(*self.ctx)
        frags = [[(f.active, f.opcode, f.data_len, f.data)
                  for _s, f in sorted(w.frag.items())] for w in self.w]
        assert frags[1] == frags[0]
        return out[1]


@pytest.mark.parametrize("case", sorted(MAC_CASES))
def test_mac_walker_cases_match_jax(case):
    pair = _Pair()
    texts = [pair.walk(_mac(pdu), 22, 0, 7 * i)
             for i, pdu in enumerate(MAC_CASES[case])]
    assert any(texts) or pair.ctx[1].events


def test_mac_segment_len_matches_jax():
    mac = np.zeros(24, dtype=np.int64)
    for octs in ([0xC0], [0xA3, 0x90], [0x8B, 0x90, 0x10], [0x10, 0x26],
                 [0xBF, 0x11, 0x00], [0x08, 0x05], [0x99, 0xA4, 0x07]):
        mac[1:1 + len(octs)] = octs
        assert TWalker.segment_len(mac, 1, 22) == \
            JWalker.segment_len(mac, 1, 22)


def _known_ops():
    """Every (opcode, MFID) pair ``mac_msg_len`` knows."""
    out = [(op, 0x00) for op in sorted(_STANDARD)]
    for table, mfid in ((_MOTOROLA, 0x90), (_HARRIS, 0xA4), (_TAIT, 0xD8)):
        out += [(op, mfid) for op in sorted(table)]
    return out


def _random_pdus(seed: int, n: int):
    """``n`` (octets, n_oct, slot) PDUs: first one message of each known
    opcode, then messages of random known or vendor opcodes (MFID 0x00,
    0x90, 0xA4, 0xD8 or random) with random bodies, multi-fragment bases
    followed by 0x10 continuations, and wholly random octets."""
    rng = np.random.default_rng(seed)
    known = _known_ops()
    bases = sorted(_MULTIFRAG_BASES)
    out = []
    queue = [[op, mfid] for op, mfid in known] if seed == 0 else []
    while len(out) < n:
        n_oct = int(rng.choice([22, 19]))
        slot = int(rng.integers(0, 2))
        r = rng.random()
        if queue:
            head = queue.pop(0)
            msgs = [head + rng.integers(0, 256, 20).tolist()]
        elif r < 0.45:
            msgs = []
            for _ in range(int(rng.integers(1, 4))):
                if rng.random() < 0.6:
                    op, mfid = known[int(rng.integers(len(known)))]
                else:
                    op = int(rng.integers(0x80, 0xC0))
                    mfid = int(rng.choice([0x00, 0x90, 0xA4, 0xD8,
                                           int(rng.integers(0, 256))]))
                ln = max(2, int(rng.integers(2, 19)))
                msgs.append([op, mfid] + rng.integers(0, 256, ln - 2).tolist())
        elif r < 0.75:
            base = int(bases[int(rng.integers(len(bases)))])
            msgs = [[base, 0x00, int(rng.integers(0, 64))]
                    + rng.integers(0, 256, 15).tolist()]
            out.append((_mac(msgs), n_oct, slot))
            for _ in range(int(rng.integers(1, 3))):
                msgs = [[0x10, int(rng.integers(0, 64))]
                        + rng.integers(0, 256, 18).tolist()]
                out.append((_mac(msgs), n_oct, slot))
            continue
        else:
            msgs = [rng.integers(0, 256, 23).tolist()]
        out.append((_mac(msgs), n_oct, slot))
    return out[:n]


@pytest.mark.parametrize("seed", range(8))
def test_mac_walker_random_pdus_match_jax(seed):
    """300 PDUs a seed, walked in turn on one walker and context: the
    walk's text, the events and the state equal after every PDU."""
    pair = _Pair()
    pdus = _random_pdus(seed, 300)
    assert len(pdus) == 300
    n_text = 0
    for i, (mac, n_oct, slot) in enumerate(pdus):
        n_text += bool(pair.walk(mac, n_oct, slot, i))
    assert n_text > 100
    if seed == 0:
        seen = {int(m[1]) for m, _n, _s in pdus}
        assert {op for op, _m in _known_ops()} <= seen


# -- the burst decoder ----------------------------------------------------------------
def _ts(kind, payload, p, key, flip=(), duid=None):
    scr = jx.generate_scramble_bits(*key, 4340) if key else None
    ts = jenc.p2_xcch_ts(payload, duid if duid is not None else
                         (3 if kind == "sacch" else 9), p, scramble=scr)
    ts[list(flip)] ^= 1
    return ts


def _payloads(kind):
    enc_msgs = _msgs(jenc)
    return [jenc.p2_mac_payload(3, enc_msgs(0, g), kind) for g in range(4)]


XCCH_CASES = {
    # name: (kind, scrambled, lcch, bit flips, relax_crc, crc flip)
    "sacch_clean": ("sacch", True, False, (), False, False),
    "sacch_errored": ("sacch", True, False, (20, 21, 90, 150, 200), False,
                      False),
    "sacch_uncorrectable": ("sacch", True, False, tuple(range(10, 70)),
                            False, False),
    "sacch_clear": ("sacch", False, False, (33, 100), False, False),
    "lcch_bad_crc": ("sacch", True, True, (), False, True),
    "sacch_bad_crc": ("sacch", True, False, (), False, True),
    "sacch_relax_crc": ("sacch", True, False, (), True, True),
    "facch_clean": ("facch", True, False, (), False, False),
    "facch_errored": ("facch", True, False, (5, 80, 190), False, False),
    "facch_clear_relax": ("facch", False, False, (), True, True),
}


@pytest.mark.parametrize("case", sorted(XCCH_CASES))
def test_xcch_burst_decode_matches_jax(case):
    kind, scr, lcch, flips, relax, crc_flip = XCCH_CASES[case]
    key = (WACN, SYSID, NAC)
    jd, td = JP2(), TP2()
    jc, tc = JCtx(), TCtx()
    for ctx in (jc, tc):
        ctx.state.p2_wacn, ctx.state.p2_sysid, ctx.state.p2_cc = key
        ctx.state.relax_crc = relax
    for g, payload in enumerate(_payloads(kind)):
        if crc_flip:
            payload = payload.copy()
            payload[-1] ^= 1
        ts = _ts(kind, payload, g, key if scr else None, flips)
        out = []
        for dec, ctx, hit in zip((jd, td), (jc, tc), _hits(60 + 180 * g)):
            dec.sf_pos = g
            out.append(dec._xcch(ts, 0, kind, scrambled=scr, lcch=lcch,
                                 ctx=ctx, have_params=True, hit=hit,
                                 slot=g % 2))
        assert out[1] == out[0]
        if case.endswith("clean"):
            assert "ERR" not in out[1]
        assert_ctx_equal(jc, tc)
        assert td.crypto == jd.crypto and td.fourv == jd.fourv


def test_xcch_blind_recovery_matches_jax():
    """Scrambled bursts to decoders that know no parameters: the first
    bursts without a superframe position are skipped, one errored burst
    fails to solve, the next solves, the pending ones are decoded
    retroactively; the same lines and the recovered state."""
    key = (WACN, SYSID, NAC)
    jd, td = JP2(), TP2()
    jc, tc = JCtx(), TCtx()
    seq = [(None, ()), (None, ()), (2, tuple(range(40, 90))),
           (3, (100,)), (4, ()), (5, ())]
    pays = _payloads("sacch")
    for i, (p, flips) in enumerate(seq):
        ts = _ts("sacch", pays[i % 4], p or 0, key, flips)
        out = []
        for dec, ctx, hit in zip((jd, td), (jc, tc), _hits(60 + 180 * i)):
            dec.sf_pos = p
            out.append(dec._xcch(ts, 0, "sacch", scrambled=True, lcch=False,
                                 ctx=ctx, have_params=False, hit=hit,
                                 slot=i % 2))
        assert out[1] == out[0]
        assert_ctx_equal(jc, tc)
    assert (tc.state.p2_wacn, tc.state.p2_sysid, tc.state.p2_cc) == key
    assert any("recovered" in e.line for e in tc.events)


# -- the stream generator and the gather ------------------------------------------------
@pytest.mark.parametrize("n_sf,default", [(1, True), (3, False), (6, False)])
def test_cc_stream_and_modulator_match_jax(n_sf, default):
    jm = None if default else _default_msgs()
    tm = None if default else _msgs(tenc)
    want = jenc.p2_cc_superframes(n_sf, WACN, SYSID, NAC, jm)
    got = tenc.p2_cc_superframes(n_sf, WACN, SYSID, NAC, tm)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    seed = 3 * n_sf
    np.testing.assert_array_equal(
        tenc.p2_cc_iq(got, seed=seed), _cc_iq(n_sf, jm, seed=seed))
    blk = tenc.p2_cc_block(got, (0, 5), (seed, 1), len(got) * SPS)
    iq = _cc_iq(n_sf, jm, seed=seed)
    np.testing.assert_array_equal(blk[0, :, 0], iq.real)
    np.testing.assert_array_equal(blk[0, :, 1], iq.imag)
    shifted = np.r_[np.zeros(5, np.uint8), got[:-5]]
    iq = tenc.p2_cc_iq(shifted, seed=1)
    np.testing.assert_array_equal(blk[1, :, 0], iq.real)


def test_xcch_gather_device_matches_jax():
    rng = np.random.default_rng(5)
    C, T, N = 3, 3000, 130
    dib = rng.integers(0, 4, (C, T)).astype(np.uint8)
    ch = rng.integers(0, C + 1, N).astype(np.int32)       # C: pad bursts
    tpos = rng.integers(0, T, N).astype(np.int32)
    tpos[:4] = (0, T - 180, T - 100, T - 1)
    want = np.asarray(J.p2_xcch_gather_device(jnp.asarray(dib),
                                              jnp.asarray(ch),
                                              jnp.asarray(tpos)))
    got = P.p2_xcch_gather_device(torch.as_tensor(dib),
                                  torch.as_tensor(ch.astype(np.int64)),
                                  torch.as_tensor(tpos.astype(np.int64)))
    assert got.dtype == torch.uint8 and got.shape == (N, 45)
    np.testing.assert_array_equal(got.numpy(), want)
    for kind, (pay, par) in P._xcch_index_arrays().items():
        for a, b in zip(J._xcch_index_arrays()[kind], (pay, par)):
            np.testing.assert_array_equal(a, b)


# -- the pipeline ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tables():
    from dsdneo_tpu_torch import params
    return params.load_tdma("p25p2", "cpu")


def _blocks(n_sf, leads=LEADS, seeds=SEEDS):
    dib = tenc.p2_cc_superframes(n_sf, WACN, SYSID, NAC, _msgs(tenc))
    return [tenc.p2_cc_block(dib, leads, s, len(dib) * SPS) for s in seeds]


def _n_matches(pipe, x):
    fe = pipe.frontend_finish(pipe.frontend_dispatch(x))
    return (fe[2].astype(np.float32) / 127.0 >= pipe.threshold).sum(1)


def _run_both(tables, blocks, **kw):
    C = blocks[0].shape[0]
    tp = P.BatchedP2ControlPipeline(C, device="cpu", tables=tables, **kw)
    jp = J.BatchedP2ControlPipeline(C, **kw)
    counts = []
    for x in blocks:
        counts.append((tp.decode_block_events(x), jp.decode_block_events(x)))
        assert counts[-1][0] == counts[-1][1]
        assert (tp.rs_fallbacks, tp.crc_errors) == (jp.rs_fallbacks,
                                                    jp.crc_errors)
        for c in range(C):
            assert_ctx_equal(jp.ctxs[c], tp.ctxs[c])
            assert (tp.decs[c].sf_pos, tp.decs[c].crypto) == \
                (jp.decs[c].sf_pos, jp.decs[c].crypto)
    return tp, jp, [a for a, _b in counts]


KEYED = {"wacn": WACN, "sysid": SYSID, "nac": NAC}


@pytest.mark.parametrize("parse_cache", [True, False])
@pytest.mark.parametrize("keyed", [True, False])
def test_pipeline_matches_jax(tables, parse_cache, keyed):
    """Three channels (leads 0/47/96), two blocks with the contexts kept:
    the events, counts and fallbacks of the JAX pipeline.  Keyed: every
    burst takes the fast screen, and every frame a channel's block holds
    whole is parsed.  Blind: each channel recovers the parameters in its
    first block and takes the fast screen in the second."""
    blocks = _blocks(3)
    tp, _jp, counts = _run_both(tables, blocks, parse_cache=parse_cache,
                                **(KEYED if keyed else {}))
    n_sym = blocks[0].shape[1] // SPS - 2
    # frames at 40 + 720 k after the lead, whole when t + 720 < n_sym
    frames = [sum(1 for k in range(9) if lead + 40 + 720 * k + 720 < n_sym)
              for lead in LEADS]
    assert frames == [9, 9, 8]
    assert tp.rs_fallbacks == 0 and tp.crc_errors == 0
    assert counts[1] == 4 * sum(frames)
    if keyed:
        assert counts[0] == 4 * sum(frames)
    for c in range(3):
        lines = [e.line for e in tp.ctxs[c].events]
        assert sum("recovered from RS parity" in ln for ln in lines) == \
            (0 if keyed else 1)
        grants = [e for e in tp.ctxs[c].events if e.fields.get("grant")]
        assert grants and grants[0].fields["tg"] == TG
        assert grants[0].fields["channel"] == GRANT_CH
        assert tp.ctxs[c].state.iden_table.entries[1][3] == 2
        assert (tp.ctxs[c].state.p2_wacn, tp.ctxs[c].state.p2_sysid) == \
            (WACN, SYSID)


def test_pipeline_matches_count_pinned(tables):
    """The blocks of these tests and the bench's 6-superframe block have
    at most the JAX package's 64 matches a channel above the threshold,
    so the JAX pipeline sees every one the port sees: the counts are
    pinned, so a longer block cannot slip in unnoticed."""
    tp = P.BatchedP2ControlPipeline(3, device="cpu", tables=tables)
    assert [_n_matches(tp, x).tolist() for x in _blocks(3)] == [
        [27, 27, 27], [27, 27, 27]]
    assert _n_matches(tp, _blocks(6, (0, 96, 47), ((0, 1, 2),))[0]
                      ).tolist() == [54, 54, 54]


def test_pipeline_bench_block_matches_jax(tables):
    """The bench's block (6 superframes, 2.1767 s) on 3 channels with the
    leads 0, 96 and 47, keyed, one block."""
    blocks = _blocks(6, (0, 96, 47), ((0, 1, 2),))
    assert blocks[0].shape[1] == 104480
    tp, _jp, counts = _run_both(tables, blocks, **KEYED)
    assert counts[0] == 4 * (18 + 17 + 18)
    assert tp.rs_fallbacks == 0 and tp.crc_errors == 0


@pytest.mark.parametrize("span", [(45, 55), (45, 120)])
def test_pipeline_errored_burst_matches_jax(tables, span):
    """``test_p2ccbatch``'s errored block (2 superframes, seed 3, a
    stretch of timeslot 0 of the first frame overwritten): at dibits
    45-55 the erasure decode corrects it, at 45-120 it cannot (counted in
    ``crc_errors``).  Then a clean second block."""
    iq = _cc_iq(n_sf=2, msgs=_default_msgs(), seed=3)
    k0 = int((40 + 20 + span[0]) / 6000.0 * 48000)
    k1 = int((40 + 20 + span[1]) / 6000.0 * 48000)
    bad = iq.copy()
    bad[k0:k1] = np.exp(1j * np.linspace(0, 9, k1 - k0)).astype(np.complex64)
    blocks = [np.stack([z.real, z.imag], -1)[None].astype(np.float32)
              for z in (bad, iq)]
    tp, _jp, counts = _run_both(tables, blocks, **KEYED)
    assert tp.rs_fallbacks >= 1
    assert tp.crc_errors == (span == (45, 120))
    assert counts[0] >= 15 and counts[1] == 24


def test_pipeline_blind_recovery_single_channel_matches_jax(tables):
    """``test_p2ccbatch``'s blind-recovery case, held to the JAX pipeline:
    the parameters are recovered in block 1, block 2 parses every burst
    through the fast screen."""
    iq = _cc_iq()
    x = np.stack([iq.real, iq.imag], -1)[None].astype(np.float32)
    tp, _jp, counts = _run_both(tables, [x, x])
    s = tp.ctxs[0].state
    assert (s.p2_wacn, s.p2_sysid, s.p2_cc) == (WACN, SYSID, NAC)
    assert counts[1] >= 30 and tp.rs_fallbacks == 0


def test_p2cc_entry_point_defaults_to_the_card(tables):
    if torch.cuda.is_available():
        assert P.BatchedP2ControlPipeline(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.BatchedP2ControlPipeline(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.BatchedP2ControlPipeline(2, tables=tables)


def test_p2cc_runs_without_the_jax_package():
    """The monitor on a C=1 block with blind recovery, in a fresh process:
    no module of the JAX package, and no jax, is ever loaded."""
    code = (
        "import sys\n"
        "from dsdneo_tpu_torch.engine.ccbatch import "
        "BatchedP2ControlPipeline\n"
        "from dsdneo_tpu_torch.protocol.p25 import encode as E\n"
        "d = E.p2_cc_superframes(2, 0xBEE00, 0x14C, 0x293)\n"
        "x = E.p2_cc_block(d, (11,), (4,), len(d) * 8)\n"
        "p = BatchedP2ControlPipeline(1, device='cpu')\n"
        "assert p.decode_block_events(x) >= 20\n"
        "assert p.ctxs[0].state.p2_cc == 0x293\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
