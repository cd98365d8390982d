"""The port's host catalogs against the JAX package's, message by message.

About 2,000 CRC-valid TSBKs over every opcode, with MFID 0, 0x90 and
0xA4 and the protect bit on and off (``protocol.p25.phase1._tsbk``);
about 1,000 CSBKs over the opcodes of ``tests/test_dmr_csbk.py``
(``protocol.dmr.csbk.decode_csbk``); about 1,000 random CAC messages
(``protocol.nxdn.decoder.NxdnDecoder._message``).  Each sequence goes
through one context in each package, so the state they carry (the iden
table, the affiliation and patch registries, the data-call assembly,
the alias blocks) carries; the event lines, their fields, the returned
values and the registries at the end must be equal.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.fec import crc as jcrc
from dsdneo_tpu.protocol.base import DecoderContext as JCtx
from dsdneo_tpu.protocol.dmr.csbk import decode_csbk as jdecode_csbk
from dsdneo_tpu.protocol.nxdn.decoder import NxdnDecoder as JNxdn
from dsdneo_tpu.protocol.p25.phase1 import P25P1Decoder as JP25
from dsdneo_tpu.symbols.framesync import SYNC_DEFS as JDEFS
from dsdneo_tpu.symbols.framesync import SyncHit as JHit
from dsdneo_tpu_torch.protocol.base import DecoderContext as TCtx
from dsdneo_tpu_torch.protocol.dmr.csbk import decode_csbk as tdecode_csbk
from dsdneo_tpu_torch.protocol.nxdn.decoder import NxdnDecoder as TNxdn
from dsdneo_tpu_torch.protocol.p25.phase1 import P25P1Decoder as TP25
from dsdneo_tpu_torch.symbols.framesync import SYNC_DEFS as TDEFS
from dsdneo_tpu_torch.symbols.framesync import SyncHit as THit


def _events(ctx):
    return [(e.line, e.protocol, e.pos, e.fields) for e in ctx.events]


def _hits(name, pos):
    return (JHit(pos, 1.0, next(d for d in JDEFS if d.name == name)),
            THit(pos, 1.0, next(d for d in TDEFS if d.name == name)))


def _registries(ctx):
    s = ctx.state
    aff = getattr(s, "affiliations", None)
    iden = getattr(s, "iden_table", None)
    return (None if aff is None else (dict(aff.units), dict(aff.groups),
                                      aff.patches),
            None if iden is None else (iden.entries, iden.version),
            {k: v for k, v in vars(s).items()
             if k not in ("affiliations", "iden_table")})


def _tsbk_bytes(rng, opcode, mfid, protect, lb):
    b = np.zeros(12, dtype=np.uint8)
    b[0] = (0x80 if lb else 0) | (0x40 if protect else 0) | opcode
    b[1] = mfid
    b[2:10] = rng.integers(0, 256, 8)
    if rng.random() < 0.5:
        # name a channel of one of the idens the sequence defines
        off = int(rng.choice([2, 3, 4, 6, 7]))
        b[off] = (int(rng.integers(0, 4)) << 4) | (int(b[off]) & 0x0F)
    v = jcrc.crc16_bits(np.unpackbits(b[:10]), init=0, xorout=0xFFFF)
    b[10], b[11] = v >> 8, v & 0xFF
    return b


def test_tsbk_catalog_matches_jax():
    rng = np.random.default_rng(21)
    jctx, tctx = JCtx(), TCtx()
    jdec, tdec = JP25(), TP25()
    for ctx in (jctx, tctx):
        ctx.state.nac = ctx.state.p2_cc = 0x293
    n = 0
    for rep in range(8):
        for mfid in (0x00, 0x01, 0x90, 0xA4):
            for protect in (False, True):
                for opcode in range(64):
                    b = _tsbk_bytes(rng, opcode, mfid, protect,
                                    lb=bool(rng.integers(2)))
                    jh, th = _hits("+P25p1", 100 + n)
                    bits = np.unpackbits(b)
                    assert (jdec._tsbk(bits, jh, jctx)
                            == tdec._tsbk(bits, th, tctx))
                    n += 1
    assert n >= 2000
    assert _events(tctx) == _events(jctx)
    assert _registries(tctx) == _registries(jctx)
    assert any("P25 FREQ" in e.line for e in tctx.events)
    assert tctx.state.iden_table.version >= 10


# the CSBK opcodes and feature sets of tests/test_dmr_csbk.py
_CSBK_MIX = ([(op, 0) for op in (4, 5, 7, 25, 28, 30, 31, 32, 33, 34, 35,
                                 38, 40, 42, 46, 48, 49, 50, 51, 52, 53,
                                 54, 55, 56, 57, 61, 62)]
             + [(op, 0x10) for op in (25, 0x3B, 0x3D, 0x3E)]
             + [(op, 0x06) for op in (1, 3, 6, 12, 17)]
             + [(op, 0x68) for op in (0x0A, 0x0B, 0x30, 0x31)])


def test_csbk_catalog_matches_jax():
    rng = np.random.default_rng(22)
    jctx, tctx = JCtx(), TCtx()
    for i in range(1000):
        op, fid = _CSBK_MIX[i % len(_CSBK_MIX)]
        bits = rng.integers(0, 2, 96).astype(np.uint8)
        bits[2:8] = [(op >> (5 - k)) & 1 for k in range(6)]
        bits[8:16] = [(fid >> (7 - k)) & 1 for k in range(8)]
        if op == 40:
            bits[16:21] = [(i // len(_CSBK_MIX) % 8 >> (4 - k)) & 1
                           for k in range(5)]
        jh, th = _hits("+DMR BS data", 10 * i)
        ms = bool(i % 7 == 0)
        assert (jdecode_csbk(bits, jctx, hit=jh, slot=i % 2, ms_sync=ms)
                == tdecode_csbk(bits, tctx, hit=th, slot=i % 2, ms_sync=ms))
    assert len(tctx.events) > 200
    assert _events(tctx) == _events(jctx)
    assert _registries(tctx) == _registries(jctx)


def test_cac_message_catalog_matches_jax():
    rng = np.random.default_rng(23)
    jctx, tctx = JCtx(), TCtx()
    jctx.mode_name = tctx.mode_name = "nxdn48"
    jdec, tdec = JNxdn(), TNxdn()
    types = list(range(64))
    for i in range(1000):
        msg = rng.integers(0, 2, 147).astype(np.uint8)
        t = types[i % 64] if i < 640 else int(rng.choice(
            [0x09, 0x0B, 0x38, 0x39, 0x3F, 0x04, 0x1A]))
        msg[2:8] = [(t >> (5 - k)) & 1 for k in range(6)]
        if t == 0x3F and rng.random() < 0.7:       # Kenwood alias blocks
            for at, v, n in ((8, 0x68, 8), (16, 0x8204, 16),
                             (32, int(rng.integers(1, 5)), 4),
                             (36, 4, 4)):
                msg[at:at + n] = [(v >> (n - 1 - k)) & 1 for k in range(n)]
        if t in (0x0B, 0x39):                        # data-call blocks
            blk = int(rng.integers(0, 4))
            msg[8:16] = [(((blk << 4) | blk) >> (7 - k)) & 1
                         for k in range(8)]
        assert jdec._message(msg, jctx) == tdec._message(msg, tctx)
        # the serial decoder hands FACCH1 80-bit and SACCH 72-bit
        # messages to the same catalog
        short = msg[:80] if i % 3 == 0 else msg[:72]
        assert jdec._message(short, jctx) == tdec._message(short, tctx)
    assert _events(tctx) == _events(jctx)
    assert _registries(tctx) == _registries(jctx)
    assert (jdec.alias_blocks, jdec.dcall is None) == (
        tdec.alias_blocks, tdec.dcall is None)
