"""The control-channel monitors of the PyTorch port against the JAX
package's (``engine/ccbatch.py``), on the CPU.

  - the three device programs (``p25_tsdu_decode_device``,
    ``dmr_csbk_decode_device``, ``nxdn_cac_decode_device``) on the same
    dibit arrays and (channel, position) lists in both packages: the
    blobs equal byte for byte; ``bptc_196_96_decode_batch`` and the CRC16
    screen on their own;
  - each pipeline on the vectors of ``data/cc_tables.npz`` at C = 2-4,
    each channel with its own lead and noise: the accepted blocks as
    sets, and every channel's event lines and fields equal;
  - the vectors themselves: the P25 and DMR streams decode to their
    payloads, the tables equal the JAX package's constants;
  - the parse cache on against off over two blocks (and a cached
    repeat's missing state update, as in the JAX package);
  - the CRC fallback: blocks whose best path fails the CRC go to the
    host list decoder, with the same result in both packages, and a
    pipeline that meets one;
  - ``BatchedP25ControlPipeline(cqpsk=True)``.

The JAX functions are jitted, as its pipelines call them.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")     # the card's machine has none

from dsdneo_tpu.engine import ccbatch as J
from dsdneo_tpu.fec import bptc as jbptc, crc as jcrc, trellis as jtrellis
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import ccbatch as P
from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode
from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean, cqpsk_iq

# kind → (samples per symbol, block dibits, modulator)
KINDS = {"p25": (10, 2200, lambda d, sps: c4fm_clean(d, sps)),
         "dmr": (10, 2200, dmr_encode.dmr_fm_iq),
         "nxdn48": (20, 1300, nxdn_encode.modulator("nxdn48"))}
LEADS = {"p25": ((5, 60, 96), (0, 33, 71)), "dmr": ((0, 47), (96, 12)),
         "nxdn48": ((7, 40, 90, 2), (61, 0, 18, 96))}


@pytest.fixture(scope="module", params=sorted(KINDS))
def kind(request):
    return request.param


@pytest.fixture(scope="module")
def cc(kind):
    return params.load_cc(kind, "cpu")


def make_blocks(kind, tv, n_ch=None, leads=None):
    sps, n_dib, modulate = KINDS[kind]
    leads = LEADS[kind] if leads is None else leads
    return [dmr_encode.vector_block(
        tv, leads[i][:n_ch], (10 * i + np.arange(len(leads[i])))[:n_ch],
        n_dib * sps, sps=sps, modulate=modulate, lead_dibits=tv["lead"])
        for i in range(2)]


def pipes(kind, cc, C, **kw):
    if kind == "p25":
        return (P.BatchedP25ControlPipeline(C, device="cpu", tables=cc, **kw),
                J.BatchedP25ControlPipeline(C, **kw))
    if kind == "dmr":
        return (P.BatchedDmrControlPipeline(C, device="cpu", tables=cc, **kw),
                J.BatchedDmrControlPipeline(C, **kw))
    return (P.BatchedNxdnControlPipeline(C, device="cpu", tables=cc, **kw),
            J.BatchedNxdnControlPipeline(C, **kw))


def events(pipe, c):
    return [(e.line, e.pos, e.fields) for e in pipe.events(c)]


# -- tables and vectors ----------------------------------------------------------
def test_cc_tables_equal_the_jax_constants(cc):
    from dsdneo_tpu.fec.device import _p25_trellis_consts
    from dsdneo_tpu_torch.fec.device import p25_trellis_consts
    for a, b, c in zip(p25_trellis_consts(), _p25_trellis_consts(),
                       (cc.np["p25_deperm"], cc.np["p25_expect"],
                        cc.np["p25_nibbles"])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(cc.tsdu_offsets.numpy(),
                                  J._tsdu_offsets())
    np.testing.assert_array_equal(cc.crc16_contrib.numpy(),
                                  J._crc16_contrib(80))
    offs, flips, src_idx, wt, a_bits, tab = J._cac_consts()
    for got, want in ((cc.cac_offs, offs), (cc.cac_flips, flips),
                      (cc.cac_src_idx, src_idx), (cc.cac_wt, wt),
                      (cc.cac_a_bits, a_bits), (cc.cac_crc_tab, tab)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cc.dmr_st_offs.numpy(), J._ST_OFFS)
    np.testing.assert_array_equal(cc.dmr_payload_offs.numpy(),
                                  J._PAYLOAD_OFFS)
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    levels = [next(d for d in SYNC_DEFS if d.name == n).levels
              for n in J.BatchedDmrControlPipeline.SYNC_NAMES]
    np.testing.assert_array_equal(cc.sync_levels.numpy(),
                                  np.stack(levels).astype(np.float32))


def test_vectors_carry_their_payloads():
    """The P25 vector's TSDUs, trellis-decoded from its dibits, and the
    DMR vector's bursts, BPTC-decoded, give the stored payloads; every
    NXDN frame sits at its start."""
    tv = params.load_cc("p25", "cpu").test_vector()
    offs = J._tsdu_offsets()
    pl = []
    for s in tv["starts"]:
        for b in range(3):
            dd = tv["dibits"][s + offs[b]]
            bits = np.zeros(196, np.uint8)
            bits[0::2], bits[1::2] = (dd >> 1) & 1, dd & 1
            pl.append(np.packbits(jtrellis.p25_12_decode(bits)[0]))
    np.testing.assert_array_equal(np.stack(pl), tv["payloads"])
    assert len(set(tv["payloads"][:, 0] & 0x3F)) >= 8
    assert (tv["payloads"][2::3, 0] >> 7 == 1).all()
    assert not (tv["payloads"][0::3, 0] >> 7).any()
    tv = params.load_cc("dmr", "cpu").test_vector()
    for k, s in enumerate(tv["starts"]):
        dd = tv["dibits"][s + J._PAYLOAD_OFFS]
        bits = np.zeros(196, np.uint8)
        bits[0::2], bits[1::2] = (dd >> 1) & 1, dd & 1
        got, err = jbptc.bptc_196_96_decode(bits)
        assert err == 0
        np.testing.assert_array_equal(np.packbits(got), tv["payloads"][k])
    tv = params.load_cc("nxdn48", "cpu").test_vector()
    assert (tv["dibits"][tv["starts"][:, None] + np.arange(10)]
            == np.array([3, 1, 3, 1, 3, 3, 1, 1, 3, 1])).all()
    for kind, n in (("p25", 14496), ("dmr", 14496), ("nxdn48", 7296)):
        assert len(params.load_cc(kind, "cpu").test_vector()["dibits"]) >= n


# -- the device programs ------------------------------------------------------------
def _random_with_vector(tv, C, T, seed):
    """``[C, T]`` random dibits with the vector laid in at a random lead
    per channel; (dibits, leads)."""
    rng = np.random.default_rng(seed)
    dib = rng.integers(0, 4, (C, T)).astype(np.uint8)
    leads = rng.integers(0, 97, C)
    for c in range(C):
        n = min(T - leads[c], len(tv["dibits"]))
        dib[c, leads[c]:leads[c] + n] = tv["dibits"][:n]
    return dib, leads


def test_device_programs_blobs_equal(kind, cc):
    tv = cc.test_vector()
    C, T = 3, 2600
    dib, leads = _random_with_vector(tv, C, T, seed=9)
    rng = np.random.default_rng(10)
    ch, pos = [], []
    for c in range(C):
        for s in tv["starts"]:
            if leads[c] + s < T:
                ch.append(c)
                pos.append(int(leads[c] + s))
        # random positions: CRC failures, clipped gathers
        ch.extend([c] * 6)
        pos.extend(rng.integers(0, T, 6).tolist())
    ch.extend([C] * 5)                           # pad rows
    pos.extend([0] * 5)
    ch, pos = np.asarray(ch, np.int32), np.asarray(pos, np.int32)
    td, tc, tp = (torch.as_tensor(dib), torch.as_tensor(ch.astype(np.int64)),
                  torch.as_tensor(pos.astype(np.int64)))
    jd, jc, jp = jnp.asarray(dib), jnp.asarray(ch), jnp.asarray(pos)
    if kind == "p25":
        got = P.p25_tsdu_decode_device(td, tc, tp, cc)
        want = J.p25_tsdu_decode_device(jd, jc, jp)
        ok_col = np.arange(12, 114, 38)
    elif kind == "dmr":
        inv = (np.arange(len(ch)) % 5 == 0).astype(np.int32)
        got = P.dmr_csbk_decode_device(td, tc, tp,
                                       torch.as_tensor(inv.astype(np.int64)),
                                       cc)
        want = J.dmr_csbk_decode_device(jd, jc, jp, jnp.asarray(inv))
        ok_col = np.array([12])
    else:
        got = P.nxdn_cac_decode_device(td, tc, tp, cc)
        want = J.nxdn_cac_decode_device(jd, jc, jp)
        ok_col = np.array([22])
    got = got.numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(want))
    oks = got[:, ok_col]
    assert oks.sum() >= C * 5 and (oks == 0).sum() >= C * 3


def test_bptc_and_crc_screen_match_jax():
    cc = params.load_cc("dmr", "cpu")
    rng = np.random.default_rng(7)
    words = []
    for i in range(96):
        w = jbptc.bptc_196_96_encode(rng.integers(0, 2, 96).astype(np.uint8))
        w[rng.choice(196, size=i % 17, replace=False)] ^= 1
        words.append(w)
    words = np.stack(words)
    gp, ge = P.bptc_196_96_decode_batch(torch.as_tensor(words), cc)
    wp, we = J.bptc_196_96_decode_batch(jnp.asarray(words))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    assert ge.dtype == torch.int32 and (ge.numpy() > 0).any()
    d96 = rng.integers(0, 2, (64, 96)).astype(np.uint8)
    for i in range(0, 64, 2):
        v = jcrc.crc16_bits(d96[i, :80], init=0, xorout=0xFFFF)
        d96[i, 80:] = [(v >> (15 - j)) & 1 for j in range(16)]
    for mask in (0xFFFF, 0xFFFF ^ 0xA5A5):
        got = P._crc16_screen(torch.as_tensor(d96), mask, cc.crc16_contrib)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(J._crc16_screen(jnp.asarray(d96), mask)))
    np.testing.assert_array_equal(
        P._pack_bits(torch.as_tensor(d96)).numpy(), np.packbits(d96, axis=1))


# -- the pipelines --------------------------------------------------------------
def _accepted(kind, pipe, fe):
    if kind == "p25":
        ac, at, _am = pipe.pick_tsdus(*fe[1:5], fe[5], dibits_dev=fe[0])
    elif kind == "dmr":
        ac, at = pipe.pick_csbks(*fe[1:])[:2]
    else:
        ac, at = pipe.pick_cacs(*fe[1:])[:2]
    return set(zip(ac.tolist(), at.tolist()))


def test_pipeline_matches_jax(kind, cc):
    """Two blocks with the contexts kept: the same accepted blocks, and
    every channel's events (lines, positions, fields) equal."""
    tv = cc.test_vector()
    xs = make_blocks(kind, tv)
    C = xs[0].shape[0]
    tp, jp = pipes(kind, cc, C)
    n_blocks = 0
    for x in xs:
        tfe = tp.frontend_finish(tp.frontend_dispatch(x))
        jfe = jp.frontend_finish(jp.frontend_dispatch(jnp.asarray(x)))
        acc = _accepted(kind, tp, tfe)
        assert acc == _accepted(kind, jp, jfe)
        assert len(acc) >= 4 * C
        n_blocks += len(acc)
        assert tp.events_from_frontend(tfe) == jp.events_from_frontend(jfe)
    for c in range(C):
        got = events(tp, c)
        assert got == events(jp, c) and len(got) >= 8
    if kind != "dmr":
        assert tp.crc_errors == jp.crc_errors


def test_pipeline_emits_the_vectors_lines(kind, cc):
    """Every block that the first block of a channel holds whole is
    parsed, with the payload event lines the JAX catalog gave the vector
    (``<kind>_tv_lines``)."""
    tv = cc.test_vector()
    xs = make_blocks(kind, tv, n_ch=2)
    tp, _jp = pipes(kind, cc, 2)
    tp.decode_block_events(xs[0])
    n_sym = KINDS[kind][1] - 2
    lines = tv["lines"]
    of = tv["line_block"]
    for c in range(2):
        lead = LEADS[kind][0][c]
        if kind == "p25":
            need = cc.np["tsdu_offsets"].max(axis=1) + 1
            whole = [3 * k + b for k, s in enumerate(tv["starts"])
                     for b in range(3) if lead + s + need[b] < n_sym]
            got = [e.line for e in tp.events(c)
                   if not e.line.startswith("Sync:")
                   and "CRC ERR" not in e.line]
        else:
            ext = P.DMR_BURST_EXTENT if kind == "dmr" else 192
            whole = [k for k, s in enumerate(tv["starts"])
                     if lead + s + ext < n_sym]
            got = [e.line for e in tp.events(c) if "CRC ERR" not in e.line]
        want = [l for l, k in zip(lines, of) if k in set(whole)]
        assert len(whole) >= 4 and got[:len(want)] == want


def test_parse_cache_on_and_off():
    """Over two blocks the parse cache re-emits the first parse's payload
    lines: on and off give the same TSBK and CSBK lines.  A cached repeat
    does not redo the catalog's state updates, so a TSDU header after a
    cached Network or RFSS Status Broadcast names the WACN, SYS, RFSS and
    site of the last one parsed (the JAX package's behaviour): headers
    are held to the JAX pipeline's, on and off."""
    cc = params.load_cc("p25", "cpu")
    x = make_blocks("p25", cc.test_vector(), n_ch=2)[0]
    runs = {}
    for flag in (True, False):
        tp, jp = pipes("p25", cc, 2, parse_cache=flag)
        for _ in range(2):
            tp.decode_block_events(x)
            jp.decode_block_events(jnp.asarray(x))
        assert (sum(len(p) for p in tp._pcache) > 0) == flag
        for c in range(2):
            assert events(tp, c) == events(jp, c)
        runs[flag] = tp
    for c in range(2):
        on, off = (
            [e for e in events(runs[f], c) if not e[0].startswith("Sync:")]
            for f in (True, False))
        assert on == off and len(on) >= 30
    dcc = params.load_cc("dmr", "cpu")
    x = make_blocks("dmr", dcc.test_vector(), n_ch=1)[0]
    on = P.BatchedDmrControlPipeline(1, device="cpu", tables=dcc)
    off = P.BatchedDmrControlPipeline(1, device="cpu", tables=dcc,
                                      parse_cache=False)
    for _ in range(2):
        on.decode_block_events(x)
        off.decode_block_events(x)
    assert events(on, 0) == events(off, 0) and on._pcache[0]


def _raw25(dd98):
    ddp = np.concatenate([dd98, np.zeros(2, np.uint8)])
    return ((ddp[0::4] << 6) | (ddp[1::4] << 4) | (ddp[2::4] << 2)
            | ddp[3::4]).astype(np.uint8)


def test_crc_fallback_matches_jax():
    """Blocks whose best path fails the CRC: the port's host list decode
    gives what the JAX package's does, recovered or not."""
    rng = np.random.default_rng(12)
    tv = params.load_cc("p25", "cpu").test_vector()
    recovered = failed = 0
    for k in range(200):
        want_pl = tv["payloads"][k % len(tv["payloads"])]
        bits = jtrellis.p25_12_encode(np.unpackbits(want_pl))
        bits[rng.choice(196, size=int(rng.integers(5, 20)),
                        replace=False)] ^= 1
        d96, _ = jtrellis.p25_12_decode(bits)
        crc_ok = jcrc.crc16_bits(d96[:80], init=0, xorout=0xFFFF) == int(
            "".join(map(str, d96[80:])), 2)
        if crc_ok:
            continue
        raw = _raw25(((bits[0::2] << 1) | bits[1::2]).astype(np.uint8))
        got = P.BatchedP25ControlPipeline._crc_fallback(raw)
        want = J.BatchedP25ControlPipeline._crc_fallback(raw)
        assert (got is None) == (want is None)
        if got is None:
            failed += 1
        else:
            np.testing.assert_array_equal(got, want)
            recovered += 1
    assert recovered >= 3 and failed >= 3


def test_pipeline_meets_a_crc_fallback():
    """The dibits of one TSBK block, in both packages' front-end output,
    carry bit errors its best path fails the CRC with and the list
    decoder recovers: both pipelines fall back once and emit the same
    events, the block's payload among them."""
    cc = params.load_cc("p25", "cpu")
    tv = cc.test_vector()
    x = make_blocks("p25", tv, n_ch=1)[0]
    tp, jp = pipes("p25", cc, 1)
    tfe = tp.frontend_finish(tp.frontend_dispatch(x))
    jfe = jp.frontend_finish(jp.frontend_dispatch(jnp.asarray(x)))
    dib = tfe[0].numpy().copy()
    assert (dib == np.asarray(jfe[0])).mean() > 0.999
    lead = LEADS["p25"][0][0]
    offs = cc.np["tsdu_offsets"]
    k = 4                                        # TSDU 1, block 1
    gp = lead + tv["starts"][k // 3] + offs[k % 3]
    rng = np.random.default_rng(0)
    for _ in range(200):
        dd = dib[0, gp].copy()
        bits = np.zeros(196, np.uint8)
        bits[0::2], bits[1::2] = (dd >> 1) & 1, dd & 1
        bits[rng.choice(196, size=8, replace=False)] ^= 1
        d96, _ = jtrellis.p25_12_decode(bits)
        hard_ok = jcrc.crc16_bits(d96[:80], init=0, xorout=0xFFFF) == int(
            "".join(map(str, d96[80:])), 2)
        dd = ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)
        fb = P.BatchedP25ControlPipeline._crc_fallback(_raw25(dd))
        if not hard_ok and fb is not None and np.array_equal(
                fb, tv["payloads"][k]):
            break
    else:
        pytest.fail("no error pattern the list decoder recovers")
    dib[0, gp] = dd
    tp.events_from_frontend((torch.as_tensor(dib),) + tuple(tfe[1:]))
    jp.events_from_frontend((jnp.asarray(dib),) + tuple(jfe[1:]))
    assert tp.crc_fallbacks == jp.crc_fallbacks == 1
    assert events(tp, 0) == events(jp, 0)


def test_p25_cqpsk_monitor_matches_jax():
    cc = params.load_cc("p25", "cpu")
    tv = cc.test_vector()
    xs = [dmr_encode.vector_block(
        tv, (9, 50), (1, 2), 2200 * 10,
        modulate=lambda d, sps, f=f: cqpsk_iq(d, sps, cfo_hz=f,
                                              snr_db=300.0),
        lead_dibits=tv["lead"])
        for f in (120.0, -75.0)]
    tp = P.BatchedP25ControlPipeline(2, cqpsk=True, device="cpu", tables=cc)
    jp = J.BatchedP25ControlPipeline(2, cqpsk=True)
    for x in xs:
        assert (tp.decode_block_events(x)
                == jp.decode_block_events(jnp.asarray(x)))
    for c in range(2):
        got = events(tp, c)
        assert got == events(jp, c)
        assert sum("Identifier Update" in e[0] for e in got) >= 2
