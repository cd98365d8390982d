"""Kernels K4 and K5 and the three control-channel monitors on the card.

K4 (the P25 trellis Viterbi) and K5 (the K=5 soft Viterbi) against their
plain PyTorch versions, bits and costs identical; each monitor's card
path against its CPU path on two channels, two blocks with the context
kept: the same accepted blocks, the same blobs, the same event lines;
the NID second-chance decode (``nid_decode_positions``) on the card,
reached through the TSDU pick; and the same card-against-CPU check for
the P25 monitor's CQPSK mode and for the DMR monitor on channels whose
FM is negated.

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
The CPU path is held to the JAX package by ``test_torch_cc.py`` and
``test_torch_viterbi.py``.
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
    words = np.stack([trellis.p25_12_encode(rng.integers(0, 2, 96))
                      for _ in range(n)]).astype(np.uint8)
    for i in range(n):
        words[i, rng.choice(196, size=i % 7, replace=False)] ^= 1
    llr = ((1 - 2 * words.astype(np.int32))
           * rng.integers(1, 128, words.shape)).astype(np.int32)
    return words, llr


@pytest.mark.cuda
@pytest.mark.parametrize("n", [192, 4099])
def test_k4_matches_plain(n):
    dev = _card()
    words, llr = _p25_words(n, seed=n)
    for lv in (None, llr):
        want = fdev.p25_12_decode_plain(
            torch.as_tensor(words), None if lv is None else torch.as_tensor(lv))
        got = fdev.p25_12_decode_batch(
            torch.as_tensor(words, device=dev),
            None if lv is None else torch.as_tensor(lv, device=dev))
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


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
