"""Kernel K6 and the D-STAR and M17 pipelines on the card.

K6 (the D-STAR header's K=3 Viterbi) against its plain PyTorch version,
bits identical, on header codewords with errors, random words, the
tie-heavy all-zero and all-one words, at word counts around its 32-word
blocks up to 65,536 and at 1, 7, 330 and 512 steps, on an unaligned view
and odd steps; more than 512 steps refused; K5 (the
K=5 Viterbi of M17's stream frames) at M17's 148 steps with its stride-0
P2 weight row, at batch sizes around its 32-word tiles; the gated
front end on the card against its CPU path with cuDNN's TF32 switch on
in the process (the FIR switches it off itself); each pipeline's card
path against its CPU path on two channels, two blocks with the contexts
kept: the same accepted frames, the same records, the same event lines.

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
The CPU path is held to the JAX package by ``test_torch_gated.py``,
``test_torch_dstar.py`` and ``test_torch_m17.py``.
"""

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.engine import demod
from dsdneo_tpu_torch.engine.dstarbatch import BatchedDstarPipeline
from dsdneo_tpu_torch.engine.m17batch import (BatchedM17VoicePipeline,
                                              _consts as m17_consts)
from dsdneo_tpu_torch.fec import conv, device as fdev
from dsdneo_tpu_torch.protocol.dmr.encode import vector_block
from dsdneo_tpu_torch.protocol.dstar import encode as dstar_encode
from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode

BLOCK = 72000                       # 1.5 s at 48 kHz
# ``gated_frontend_step`` card vs CPU: the FIR and the discriminator's
# atan2 round otherwise (~1e-6), moved further where a timing window is
# mostly dead air (see test_torch_gated.py, SOFT_TOL)
SOFT_TOL = 0.1


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _k3_words(n, seed, steps=330):
    """``n`` codewords of ``steps`` steps of the K=3 code (random info
    bits, the last two 0 where there are three or more; the encoder
    vectorized and held to the lattice run forward on the first words)
    with 0-3 flipped bits, then 8 random words and the all-zero and
    all-one words: [n + 10, 2 * steps] uint8."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (n, steps))
    if steps >= 3:
        info[:, -2:] = 0
    b1 = np.pad(info, ((0, 0), (1, 0)))[:, :-1]
    b2 = np.pad(info, ((0, 0), (2, 0)))[:, :-2]
    w = np.stack([info ^ b1 ^ b2, info ^ b2], -1).reshape(n, 2 * steps)
    for i in range(min(n, 3)):
        st, ref = 0, []
        for b in info[i].tolist():
            ns = ((st << 1) | b) & 3
            pa, a1, a0, _pb, c1, c0 = fdev.K3_TRANS[ns]
            ref += [a1, a0] if st == pa else [c1, c0]
            st = ns
        assert np.array_equal(w[i], ref)
    w = w.astype(np.uint8)
    k = np.arange(n) % 4
    for j in range(3):
        pos = rng.integers(0, 2 * steps, n)
        w[np.arange(n)[k > j], pos[k > j]] ^= 1
    rest = [rng.integers(0, 2, (8, 2 * steps)).astype(np.uint8),
            np.zeros((1, 2 * steps), np.uint8),
            np.ones((1, 2 * steps), np.uint8)]
    return np.concatenate([w, *rest])


@pytest.mark.cuda
@pytest.mark.parametrize("N, steps", [
    (0, 330), (1, 330), (31, 330), (32, 330), (33, 330), (888, 330),
    (4099, 330), (65536, 330), (40, 1), (40, 7), (75, 512), (4099, 512)])
def test_k6_matches_plain(N, steps):
    """``N`` words (the random, all-zero and all-one words first) of
    ``steps`` steps, bits identical to the plain version's."""
    dev = _card()
    words = _k3_words(max(N - 10, 0), N, steps)
    words = np.concatenate([words[-10:], words[:-10]])[:N]
    want = fdev.conv_k3_decode_plain(torch.as_tensor(words))
    before = fdev.conv_k3_decode_batch.launches
    got = fdev.conv_k3_decode_batch(torch.as_tensor(words, device=dev))
    torch.cuda.synchronize()
    assert fdev.conv_k3_decode_batch.launches == before + (N > 0)
    assert got.shape == (N, steps) and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k6_refuses_more_than_512_steps():
    dev = _card()
    with pytest.raises(RuntimeError):
        fdev.conv_k3_decode_batch(torch.zeros((4, 1026), dtype=torch.uint8,
                                              device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 4099])
def test_k6_takes_unaligned_and_odd_views(n):
    """An input one byte into a buffer (rows off the 4-byte copies and
    16-byte reads), and an odd step count (odd row lengths), decode as
    the plain version."""
    dev = _card()
    words = _k3_words(n, 3)
    buf = torch.zeros(words.size + 1, dtype=torch.uint8, device=dev)
    buf[1:] = torch.as_tensor(words.ravel(), device=dev)
    got = fdev.conv_k3_decode_batch(buf[1:].view(words.shape))
    assert torch.equal(got.cpu(),
                       fdev.conv_k3_decode_plain(torch.as_tensor(words)))
    odd = torch.as_tensor(words[:, :658].copy())
    assert torch.equal(fdev.conv_k3_decode_batch(odd.to(dev)).cpu(),
                       fdev.conv_k3_decode_plain(odd))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4099])
def test_k5_at_m17s_shape(n):
    """K5 as ``m17_stream_decode_device`` calls it: [n, 296] 0/1 symbols
    (the 24 punctured ones 0), the path's own weight row expanded to a
    stride-0 view, 0-6 flipped kept symbols; hard and, off the path, soft
    symbols on the same row; bits equal the plain version's."""
    dev = _card()
    rng = np.random.default_rng(n + 17)
    row = m17_consts(str(dev))["wt"]
    keep = row.cpu().numpy() > 0
    bits = np.concatenate([rng.integers(0, 2, (n, 144)),
                           np.zeros((n, 4), np.int64)], axis=1)
    sym = conv.encode_rows(bits)
    flip = (rng.random((n, 296)) < rng.integers(0, 7, (n, 1)) / 272) & keep
    sym[flip] = 1.0 - sym[flip]
    sym[:, ~keep] = 0.0
    soft = np.clip(sym + rng.normal(0, 0.3, sym.shape), 0, 1) * keep
    wt = row.expand(n, -1)
    outs = []
    for s in (sym, soft.astype(np.float32)):
        got = fdev.conv_k5_decode_batch(torch.as_tensor(s, device=dev), wt)
        want = fdev.conv_k5_decode_plain(torch.as_tensor(s), wt.cpu())
        assert torch.equal(got.cpu(), want)
        outs.append(got.cpu().numpy())
    if n:
        assert (outs[0][:, :144] == bits[:, :144]).mean() > 0.99


def _blocks(kind):
    t = params.load_event(kind, "cpu")
    tv = t.test_vector()
    mod = dstar_encode.fm_iq if kind == "dstar" else m17_encode.fm_iq
    return [vector_block(tv, leads, seeds, BLOCK, modulate=mod,
                         lead_dibits=tv["lead"])
            for leads, seeds in (((5, 77), (1, 2)), ((40, 0), (3, 4)))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dstar", "m17"])
def test_gated_front_end_on_card_matches_cpu(kind):
    dev = _card()
    x = _blocks(kind)[0]
    four = kind == "m17"
    taps = firdes.channel_lpf(48000.0, "12k5" if four else "6k25")
    n_sym = BLOCK // 10 - 2
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        gd, gs = demod.gated_frontend_step(torch.as_tensor(x, device=dev),
                                           torch.as_tensor(taps, device=dev),
                                           10.0, n_sym, four)
    wd, ws = demod.gated_frontend_step(torch.as_tensor(x),
                                       torch.as_tensor(taps), 10.0, n_sym,
                                       four)
    gs, ws = gs.cpu().numpy(), ws.numpy()
    assert np.abs(gs - ws).max() <= SOFT_TOL
    thr = np.array([0.0, 2.0, -2.0] if four else [0.0], np.float32)
    off = np.abs(ws[..., None] - thr).min(axis=-1) > SOFT_TOL
    np.testing.assert_array_equal(gd.cpu().numpy()[off], wd.numpy()[off])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dstar", "m17"])
def test_pipeline_on_card_matches_cpu(kind):
    dev = _card()

    def make(where):
        t = params.load_event(kind, where)
        return (BatchedDstarPipeline(2, device=where, tables=t)
                if kind == "dstar" else
                BatchedM17VoicePipeline(2, monitor=set(), device=where,
                                        tables=t))
    card, cpu = make(dev), make("cpu")
    counter = (fdev.conv_k3_decode_batch if kind == "dstar"
               else fdev.conv_k5_decode_batch)
    before = counter.launches
    for x in _blocks(kind):
        n_card = card.decode_block_events(torch.as_tensor(x, device=dev))
        n_cpu = cpu.decode_block_events(x)
        assert n_card == n_cpu and n_card >= (2 if kind == "dstar" else 40)
        a, b = card.last_frames, cpu.last_frames
        for u, v in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(u, v)
        for u, v in zip(a[-1], b[-1]):
            np.testing.assert_array_equal(u, v)
        for c in range(2):
            assert card.channel_state(c) == cpu.channel_state(c)
    assert counter.launches == before + 2
    for c in range(2):
        assert ([(e.line, e.pos) for e in card.events(c)]
                == [(e.line, e.pos) for e in cpu.events(c)])
