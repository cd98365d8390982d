"""Kernels K4 and K5 and the four control-channel monitors on the card.

K4 (the P25 trellis Viterbi) and K5 (the K=5 soft Viterbi) against their
plain PyTorch versions, bits and costs identical: at batch sizes around
the kernels' 32-word tiles (0, 1, 31, 32, 33, 4099 words), K4 on LLRs
and on hard bits (which it turns into ±64 LLRs itself), K5 at the CAC's
175 steps and M17's 148 (and at 1, 33 and 512, around its 32-step
chunks) on hard and soft inputs, on inputs whose candidate costs tie,
with one weight row for every word (a stride-0 view) and on unaligned
views; each monitor's card
path against its CPU path on two channels, two blocks with the context
kept: the same accepted blocks, the same blobs, the same event lines;
the NID second-chance decode (``nid_decode_positions``) on the card,
reached through the TSDU pick; and the same card-against-CPU check for
the P25 monitor's CQPSK mode and for the DMR monitor on channels whose
FM is negated; the P25 Phase 2 TDMA monitor at 64 channels against its
CPU path (kernel K1 on its front end).

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
The CPU path is held to the JAX package by ``test_torch_cc.py``,
``test_torch_p2cc.py`` and ``test_torch_viterbi.py``.
"""

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import ccbatch
from dsdneo_tpu_torch.fec import conv, device as fdev, trellis
from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode
from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean, cqpsk_iq

LEADS = ((7, 61), (0, 33))
SEEDS = ((1, 2), (3, 4))
# monitor → (tables, samples per symbol, block dibits, modulator, factory)
MONITORS = {
    "p25": ("p25", 10, 2400, lambda d, sps: c4fm_clean(d, sps),
            lambda dev, t: ccbatch.BatchedP25ControlPipeline(
                2, device=dev, tables=t)),
    "dmr": ("dmr", 10, 2400, dmr_encode.dmr_fm_iq,
            lambda dev, t: ccbatch.BatchedDmrControlPipeline(
                2, device=dev, tables=t)),
    "nxdn48": ("nxdn48", 20, 1400, nxdn_encode.modulator("nxdn48"),
               lambda dev, t: ccbatch.BatchedNxdnControlPipeline(
                   2, device=dev, tables=t)),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _p25_words(n: int, seed: int):
    """Encoded TSBK trellis words with 0-6 flipped bits each, and int32
    LLRs of random magnitude on them."""
    rng = np.random.default_rng(seed)
    words = np.array([trellis.p25_12_encode(rng.integers(0, 2, 96))
                      for _ in range(n)], dtype=np.uint8).reshape(n, 196)
    for i in range(n):
        words[i, rng.choice(196, size=i % 7, replace=False)] ^= 1
    llr = ((1 - 2 * words.astype(np.int32))
           * rng.integers(1, 128, words.shape)).astype(np.int32)
    return words, llr


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 192, 4099])
def test_k4_matches_plain(n):
    dev = _card()
    words, llr = _p25_words(n, seed=n)
    for lv in (None, llr):
        want = fdev.p25_12_decode_plain(
            torch.as_tensor(words), None if lv is None else torch.as_tensor(lv))
        before = fdev.p25_12_decode_batch.launches
        got = fdev.p25_12_decode_batch(
            torch.as_tensor(words, device=dev),
            None if lv is None else torch.as_tensor(lv, device=dev))
        torch.cuda.synchronize()
        assert fdev.p25_12_decode_batch.launches == before + (n > 0)
        assert got[0].shape == (n, 96) and got[1].shape == (n,)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 4099])
def test_k4_hard_bits_equal_their_llrs(n):
    """The kernel's uint8 mode is its LLR mode on the ±64 LLRs the bits
    stand for, and the plain version on the bits; bool bits go in as
    uint8."""
    dev = _card()
    words, _llr = _p25_words(n, seed=7 * n)
    bt = torch.as_tensor(words, device=dev)
    hard = fdev.p25_12_decode_batch(bt)
    soft = fdev.p25_12_decode_batch(bt, fdev._hard_llr(bt))
    flag = fdev.p25_12_decode_batch(bt.bool())
    want = fdev.p25_12_decode_plain(torch.as_tensor(words))
    for got in (hard, soft, flag):
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_k4_takes_bits_as_uint8_or_bool_only(dtype):
    """The kernel reads bits as bytes: the wrapper raises on any other
    dtype rather than cast (a cast would wrap values the plain version
    reads whole)."""
    dev = _card()
    words, _llr = _p25_words(4, seed=11)
    with pytest.raises(ValueError, match="bits196"):
        fdev.p25_12_decode_batch(torch.as_tensor(words, device=dev).to(dtype))


def _k5_case(n: int, steps: int, soft: bool, seed: int):
    """``n`` K5 inputs of ``steps`` steps: random bits with 4 flush bits
    through the K=5 code, 1 in 7 symbols punctured (weight 0), 0-4 flips;
    ``soft``: noise on the symbols, clipped to [0, 1], and random
    weights."""
    rng = np.random.default_rng(seed)
    bits = np.concatenate([rng.integers(0, 2, (n, max(steps - 4, 0))),
                           np.zeros((n, min(steps, 4)), np.int64)], axis=1)
    sym = conv.encode_rows(bits)
    wt = (rng.random((n, 2 * steps)) >= 1 / 7).astype(np.float32)
    flip = rng.random((n, 2 * steps)) < rng.integers(0, 5, (n, 1)) / (
        2 * steps)
    sym[flip] = 1.0 - sym[flip]
    if soft:
        sym = np.clip(sym + rng.normal(0, 0.3, sym.shape), 0, 1)
        wt = wt * rng.random(wt.shape)
    return sym.astype(np.float32), wt.astype(np.float32)


def _k5_equal(dev, sym, wt):
    """Launch K5 on ``sym`` and ``wt`` (numpy or tensors) and hold it to
    the plain version on the CPU."""
    s, w = (torch.as_tensor(a) for a in (sym, wt))
    before = fdev.conv_k5_decode_batch.launches
    got = fdev.conv_k5_decode_batch(s.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert fdev.conv_k5_decode_batch.launches == before + (s.numel() > 0)
    want = fdev.conv_k5_decode_plain(s.cpu(), w.cpu())
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True])
def test_k5_matches_plain(soft):
    dev = _card()
    rng = np.random.default_rng(11)
    syms, wts = [], []
    for i in range(300):
        enc = conv.encode(rng.integers(0, 2, 171)).astype(np.float32)
        wt = np.ones_like(enc)
        wt[rng.choice(enc.size, size=enc.size // 7, replace=False)] = 0.0
        j = rng.choice(enc.size, size=i % 5, replace=False)
        enc[j] = 1.0 - enc[j]
        if soft:
            enc = np.clip(enc + rng.normal(0, 0.3, enc.shape), 0, 1)
            wt = wt * rng.random(enc.shape).astype(np.float32)
        syms.append(enc.astype(np.float32))
        wts.append(wt.astype(np.float32))
    sym, wt = np.stack(syms), np.stack(wts)
    want = fdev.conv_k5_decode_plain(torch.as_tensor(sym),
                                     torch.as_tensor(wt))
    got = fdev.conv_k5_decode_batch(torch.as_tensor(sym, device=dev),
                                    torch.as_tensor(wt, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [175, 148])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4099])
def test_k5_matches_plain_around_the_tile(n, steps):
    dev = _card()
    for soft in (False, True):
        _k5_equal(dev, *_k5_case(n, steps, soft, seed=n + steps + soft))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 33, 512])
def test_k5_matches_plain_around_the_chunks(steps):
    """Step counts at the edges of the kernel's 32-step chunks and its
    512-step limit (whose survivors and buffers need more than 48 KiB of
    shared memory a block)."""
    dev = _card()
    for soft in (False, True):
        _k5_equal(dev, *_k5_case(65, steps, soft, seed=steps + soft))
    sym, wt = _k5_case(65, steps, True, seed=steps)
    row = torch.as_tensor(wt[0])
    _k5_equal(dev, sym, row.to(dev).expand(65, -1))


@pytest.mark.cuda
def test_k5_ties_take_pa_and_start_from_state_0():
    """Every candidate ties (symbols 0.5 with unit weights, or zero
    weights): the kernel keeps pa where pb is not strictly cheaper, as
    the plain version does, so the path stays in state 0; and a word
    encoded from state 15 is decoded from state 0, whose 1e30 start
    keeps the other states out of the first steps."""
    dev = _card()
    n, steps = 40, 175
    half = np.full((n, 2 * steps), 0.5, np.float32)
    for sym, wt in ((half, np.ones_like(half)),
                    (half, np.zeros_like(half)),
                    (np.zeros_like(half), np.zeros_like(half))):
        _k5_equal(dev, sym, wt)
        got = fdev.conv_k5_decode_batch(torch.as_tensor(sym, device=dev),
                                        torch.as_tensor(wt, device=dev))
        assert not got.any()
    rng = np.random.default_rng(3)
    sym = np.zeros((n, 2 * steps), np.float32)
    st = np.full(n, 15, np.int64)
    for i in range(steps):
        b = rng.integers(0, 2, n) if i < steps - 4 else np.zeros(n, np.int64)
        sym[:, 2 * i] = conv._O1[st, b]
        sym[:, 2 * i + 1] = conv._O2[st, b]
        st = conv._NEXT[st, b]
    sym[:, 1::7] = 0.5
    _k5_equal(dev, sym, np.ones_like(sym))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [175, 148])
def test_k5_broadcast_weight_row_equals_materialised(steps):
    """A stride-0 view of one weight row (as the NXDN and M17 paths pass
    it) decodes as the same weights written out row by row."""
    dev = _card()
    for soft in (False, True):
        sym, wt = _k5_case(1000, steps, soft, seed=steps + 5 * soft)
        row = torch.as_tensor(wt[0], device=dev)
        st = torch.as_tensor(sym, device=dev)
        view = row.expand(1000, -1)
        assert view.stride() == (0, 1)
        a = fdev.conv_k5_decode_batch(st, view)
        b = fdev.conv_k5_decode_batch(st, view.contiguous())
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        _k5_equal(dev, sym, view)


@pytest.mark.cuda
def test_k4_k5_take_unaligned_views():
    """Inputs that start off the kernels' 16- and 8-byte load boundaries
    (a contiguous view one element into a buffer) decode as aligned
    copies do."""
    dev = _card()
    words, llr = _p25_words(64, seed=5)
    buf = torch.zeros(llr.size + 1, dtype=torch.int32, device=dev)
    buf[1:] = torch.as_tensor(llr.ravel(), device=dev)
    view = buf[1:].view(64, 196)
    assert view.data_ptr() % 16
    got = fdev.p25_12_decode_batch(torch.as_tensor(words, device=dev), view)
    want = fdev.p25_12_decode_plain(torch.as_tensor(words),
                                    torch.as_tensor(llr))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    rng = np.random.default_rng(6)
    sym = np.stack([conv.encode(rng.integers(0, 2, 171))
                    for _ in range(64)]).astype(np.float32)
    sbuf = torch.zeros(sym.size + 1, dtype=torch.float32, device=dev)
    sbuf[1:] = torch.as_tensor(sym.ravel(), device=dev)
    wt = torch.ones(sym.shape, dtype=torch.float32, device=dev)
    got = fdev.conv_k5_decode_batch(sbuf[1:].view(sym.shape), wt)
    want = fdev.conv_k5_decode_plain(torch.as_tensor(sym), wt.cpu())
    assert torch.equal(got.cpu(), want)
    # hard bits one byte into a buffer (off the 16-byte staging copies);
    # a weight row 4 bytes into one, broadcast (off the 8-byte pairs)
    bbuf = torch.zeros(words.size + 1, dtype=torch.uint8, device=dev)
    bbuf[1:] = torch.as_tensor(words.ravel(), device=dev)
    got = fdev.p25_12_decode_batch(bbuf[1:].view(64, 196))
    want = fdev.p25_12_decode_plain(torch.as_tensor(words))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    wbuf = torch.zeros(sym.shape[1] + 1, dtype=torch.float32, device=dev)
    wbuf[1:] = torch.as_tensor(rng.random(sym.shape[1]), device=dev)
    view = wbuf[1:].expand(64, -1)
    assert view.data_ptr() % 8 and view.stride() == (0, 1)
    got = fdev.conv_k5_decode_batch(sbuf[1:].view(sym.shape), view)
    want = fdev.conv_k5_decode_plain(torch.as_tensor(sym), view.cpu())
    assert torch.equal(got.cpu(), want)


def _blocks(kind):
    _t, sps, n_dib, modulate, _make = MONITORS[kind]
    tv = params.load_cc(MONITORS[kind][0], "cpu").test_vector()
    return [dmr_encode.vector_block(tv, LEADS[i], SEEDS[i], n_dib * sps,
                                    sps=sps, modulate=modulate,
                                    lead_dibits=tv["lead"])
            for i in range(2)]


def _last(pipe):
    return (pipe.last_tsdus if isinstance(pipe,
                                          ccbatch.BatchedP25ControlPipeline)
            else pipe.last_csbks
            if isinstance(pipe, ccbatch.BatchedDmrControlPipeline)
            else pipe.last_cacs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(MONITORS))
def test_monitor_on_card_matches_cpu(kind):
    dev = _card()
    tkind, _sps, _n, _mod, make = MONITORS[kind]
    card = make(dev, params.load_cc(tkind, dev))
    cpu = make("cpu", params.load_cc(tkind, "cpu"))
    launches = (fdev.p25_12_decode_batch.launches,
                fdev.conv_k5_decode_batch.launches)
    for x in _blocks(kind):
        n_card = card.decode_block_events(torch.as_tensor(x, device=dev))
        n_cpu = cpu.decode_block_events(x)
        assert n_card == n_cpu and n_card >= 2 * 4
        for a, b in zip(_last(card), _last(cpu)):
            np.testing.assert_array_equal(a, b)
    for c in range(2):
        assert ([(e.line, e.pos) for e in card.events(c)]
                == [(e.line, e.pos) for e in cpu.events(c)])
    if kind == "p25":
        assert fdev.p25_12_decode_batch.launches == launches[0] + 2
    if kind == "nxdn48":
        assert fdev.conv_k5_decode_batch.launches == launches[1] + 2


@pytest.mark.cuda
def test_nid_second_chance_on_card():
    """With the NID decoded for only the 2 strongest candidates, the
    TSDU pick decodes the NID of every other hit on the card
    (``nid_decode_positions``): the events equal the CPU path's and the
    full top-K decode's."""
    dev = _card()
    xs = _blocks("p25")
    runs = {}
    for name, where, k in (("card2", dev, 2), ("cpu2", "cpu", 2),
                           ("card", dev, None)):
        pipe = ccbatch.BatchedP25ControlPipeline(
            2, device=where, tables=params.load_cc("p25", where))
        if k is not None:
            pipe.NID_TOPK = k
        calls = []
        inner = pipe.nid_decode_positions

        def counted(d, ch, pos, inner=inner, calls=calls):
            calls.append(len(ch))
            return inner(d, ch, pos)

        pipe.nid_decode_positions = counted
        for x in xs:
            pipe.decode_block_events(torch.as_tensor(x, device=where))
        runs[name] = ([[e.line for e in pipe.events(c)] for c in range(2)],
                      sum(calls))
    assert runs["card2"][1] >= 2 * 6 and runs["card"][1] == 0
    assert runs["card2"][0] == runs["cpu2"][0] == runs["card"][0]


@pytest.mark.cuda
def test_p25_cqpsk_monitor_on_card_matches_cpu():
    """``BatchedP25ControlPipeline(cqpsk=True)`` on the card against its
    CPU path on two channels with their own carrier offsets, two blocks
    with the contexts kept: the same accepted TSDUs, blobs and events."""
    dev = _card()
    tv = params.load_cc("p25", "cpu").test_vector()
    xs = [dmr_encode.vector_block(
        tv, LEADS[i], SEEDS[i], 2400 * 10,
        modulate=lambda d, sps, f=f: cqpsk_iq(d, sps, cfo_hz=f),
        lead_dibits=tv["lead"]) for i, f in enumerate((120.0, -75.0))]
    card = ccbatch.BatchedP25ControlPipeline(
        2, cqpsk=True, device=dev, tables=params.load_cc("p25", dev))
    cpu = ccbatch.BatchedP25ControlPipeline(
        2, cqpsk=True, device="cpu", tables=params.load_cc("p25", "cpu"))
    before = fdev.p25_12_decode_batch.launches
    for x in xs:
        n_card = card.decode_block_events(torch.as_tensor(x, device=dev))
        assert n_card == cpu.decode_block_events(x) and n_card >= 2 * 4
        for a, b in zip(card.last_tsdus, cpu.last_tsdus):
            np.testing.assert_array_equal(a, b)
    assert fdev.p25_12_decode_batch.launches == before + 2
    for c in range(2):
        assert ([(e.line, e.pos) for e in card.events(c)]
                == [(e.line, e.pos) for e in cpu.events(c)])


@pytest.mark.cuda
def test_dmr_monitor_on_an_inverted_channel_on_card_matches_cpu():
    """``BatchedDmrControlPipeline`` on channels whose FM is negated (the
    voice-pattern hits are the inverted-data hypothesis) on the card
    against its CPU path, two blocks with the contexts kept: the same
    accepted CSBKs, blobs and events, and CSBKs parsed."""
    dev = _card()
    tv = params.load_cc("dmr", "cpu").test_vector()
    xs = [dmr_encode.vector_block(tv, LEADS[i], SEEDS[i], 2400 * 10,
                                  modulate=dmr_encode.dmr_fm_iq,
                                  lead_dibits=tv["lead"], invert=True)
          for i in range(2)]
    card = ccbatch.BatchedDmrControlPipeline(
        2, device=dev, tables=params.load_cc("dmr", dev))
    cpu = ccbatch.BatchedDmrControlPipeline(
        2, device="cpu", tables=params.load_cc("dmr", "cpu"))
    for x in xs:
        n_card = card.decode_block_events(torch.as_tensor(x, device=dev))
        assert n_card == cpu.decode_block_events(x) and n_card >= 2 * 10
        for a, b in zip(card.last_csbks, cpu.last_csbks):
            np.testing.assert_array_equal(a, b)
    for c in range(2):
        assert ([(e.line, e.pos) for e in card.events(c)]
                == [(e.line, e.pos) for e in cpu.events(c)])


@pytest.mark.cuda
def test_p2cc_monitor_on_card_matches_cpu():
    """The P25 Phase 2 TDMA control-channel monitor at 64 channels (own
    lead of 0-96 dibits and own noise each), keyed, two blocks with the
    contexts kept: every channel's events on the card equal the CPU
    path's, every burst takes the fast screen, and K1 is launched once a
    block."""
    from dsdneo_tpu_torch.ops import fir_discriminate as k1mod
    from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode
    dev = _card()
    C = 64
    key = {"wacn": 0xBEE00, "sysid": 0x14C, "nac": 0x293}
    dib = p25_encode.p2_cc_superframes(3, key["wacn"], key["sysid"],
                                       key["nac"])
    rng = np.random.default_rng(13)
    leads = rng.integers(0, 97, C)
    blocks = [p25_encode.p2_cc_block(dib, leads, rng.integers(0, 1 << 20, C),
                                     len(dib) * 8) for _ in range(2)]
    card = ccbatch.BatchedP2ControlPipeline(
        C, device=dev, tables=params.load_tdma("p25p2", dev), **key)
    cpu = ccbatch.BatchedP2ControlPipeline(
        C, device="cpu", tables=params.load_tdma("p25p2", "cpu"), **key)
    k1 = k1mod.fir_discriminate.launches
    for x in blocks:
        n_card = card.decode_block_events(torch.as_tensor(x, device=dev))
        n_cpu = cpu.decode_block_events(x)
        assert n_card == n_cpu and n_card >= C * 4 * 8
        for a, b in zip(card.last_xcch, cpu.last_xcch):
            np.testing.assert_array_equal(a, b)
    assert k1mod.fir_discriminate.launches == k1 + 2
    assert card.rs_fallbacks == cpu.rs_fallbacks == 0
    assert card.crc_errors == cpu.crc_errors == 0
    for c in range(C):
        assert ([(e.line, e.pos, e.fields) for e in card.events(c)]
                == [(e.line, e.pos, e.fields) for e in cpu.events(c)])
