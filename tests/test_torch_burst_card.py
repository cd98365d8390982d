"""Kernel K8, the YSF and dPMR voice paths and the EDACS monitor on the
card.

K8 (the one-pole IIR of the audio filters) against its plain PyTorch
version, bit for bit, behind all four filters: 4-aligned rows, the YSF
and dPMR PCM shapes, ragged lengths, one step, a row shorter than a
tile, one row and 33, each also as a view 4 bytes off alignment (the
bulk copies' 16-byte-aligned supersets), with a silent stretch (both
flush subnormals to zero); the cascade (de-emphasis then low-pass in
one launch) against two plain calls; every mode of the kernel, also
from a carried state over successive blocks; ``condition_audio`` on the
card against the CPU; each path's
card run against its CPU path on two channels, two blocks with the
carry or the contexts kept: the same accepted frames, bits and error
counts, the f16 PCM within 2e-3 of the peak (YSF, dPMR), the same blobs
and event lines (EDACS).

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
The CPU paths are held to the JAX package by
``test_torch_audio_filters.py``, ``test_torch_ysf.py``,
``test_torch_dpmr.py`` and ``test_torch_edacs.py``.
"""

import functools

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.dsp import audio_filters as af
from dsdneo_tpu_torch.engine.ccbatch import BatchedEdacsControlPipeline
from dsdneo_tpu_torch.engine.dpmrbatch import BatchedDpmrVoicePipeline
from dsdneo_tpu_torch.engine.ysfbatch import BatchedYsfVoicePipeline
from dsdneo_tpu_torch.protocol.dmr.encode import vector_block
from dsdneo_tpu_torch.protocol.dpmr import encode as dpmr_encode
from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
from dsdneo_tpu_torch.protocol.ysf import encode as ysf_encode

FILTERS = ("deemphasis", "dc_block", "audio_lpf", "audio_hpf")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _audio(R, T, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, T)) * 0.3).astype(np.float32)
    x[:, T // 3:T // 3 + 900] = 0.0            # decays to subnormals
    return x


def _on_card(x, dev, offset=0):
    """``x`` on the card, ``offset`` floats into its buffer (1: a view 4
    bytes off the 16-byte alignment of the kernel's bulk copies)."""
    buf = torch.zeros(x.size + offset, dtype=torch.float32, device=dev)
    buf[offset:] = torch.as_tensor(x.ravel(), device=dev)
    return buf[offset:].view(x.shape)


@functools.lru_cache(maxsize=None)
def _plain(name, shape):
    """The filter ``name`` on the CPU (its plain version) of the audio of
    ``shape``, once for both offsets."""
    return getattr(af, name)(torch.as_tensor(_audio(*shape, seed=shape[1])))


# the YSF and dPMR paths' decoded PCM, a ragged length, one step, a row
# shorter than a tile, a length that is not a multiple of the tile, one
# row and 33 rows (one past a block of 8, 16 or 32)
K8_SHAPES = [(64, 4096), (33, 1037), (5, 130), (320, 22400), (320, 17920),
             (320, 4001), (7, 1), (1, 100), (1, 4001), (33, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", K8_SHAPES)
@pytest.mark.parametrize("name", FILTERS)
def test_k8_matches_plain(name, shape, offset):
    dev = _card()
    x = _audio(*shape, seed=shape[1])
    before = af.one_pole.launches
    got = getattr(af, name)(_on_card(x, dev, offset))
    torch.cuda.synchronize()
    want = _plain(name, shape)
    assert af.one_pole.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(320, 22400), (320, 17920), (33, 4001),
                                   (1, 1), (9, 300)])
def test_k8_cascade_is_one_launch_of_two_filters(shape, offset):
    """``condition_audio`` with de-emphasis and low-pass on makes one K8
    launch (the cascade), equal bit for bit to two ``one_pole_plain``
    calls; ``one_pole_cascade`` with other poles likewise."""
    dev = _card()
    x = _audio(*shape, seed=shape[1] + 1)
    xc = _on_card(x, dev, offset)
    before = af.one_pole.launches
    got = af.condition_audio(xc, "nfm", 3400)
    torch.cuda.synchronize()
    assert af.one_pole.launches == before + 1
    de, lp = af.deemphasis_pole(8000.0, 750.0), af.lowpass_pole(8000.0,
                                                                3400.0)
    assert torch.equal(got.cpu(), _plain_cascade(shape, de, lp))
    got = af.one_pole_cascade(xc, 0.3, 0.95)
    assert torch.equal(got.cpu(), _plain_cascade(shape, 0.3, 0.95))


@functools.lru_cache(maxsize=None)
def _plain_cascade(shape, a, a2):
    """Two ``one_pole_plain`` calls, poles ``a`` then ``a2``, on the CPU
    on the cascade test's audio of ``shape``."""
    x = torch.as_tensor(_audio(*shape, seed=shape[1] + 1))
    return af.one_pole_plain(af.one_pole_plain(x, a), a2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_k8_every_mode(mode):
    """The kernel's three modes (y, x - y, the cascade) with other poles,
    on 4-aligned and ragged rows, aligned and not, over block edges (8
    rows a block)."""
    dev = _card()
    for shape, offset in (((70, 1024), 0), ((41, 1037), 0), ((41, 1037), 1)):
        x = _audio(*shape, seed=3 + mode)
        got = af._one_pole_card(_on_card(x, dev, offset), mode, 0.9, 0.4)
        xt = torch.as_tensor(x)
        want = (af.one_pole_plain(af.one_pole_plain(xt, 0.9), 0.4)
                if mode == 2 else af.one_pole_plain(xt, 0.9, bool(mode)))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_k8_carries_its_state_across_blocks(mode):
    """Each mode from a carried ``[R, 2]`` state over blocks of 1037, 1
    and 2058 steps (ragged, one step, aligned after an odd start) equals
    the plain version on the whole rows, and the state ends as the plain
    version's."""
    dev = _card()
    x = _audio(41, 3096, seed=7 + mode)
    xt = torch.as_tensor(x)
    st_c = torch.zeros((41, 2), dtype=torch.float32, device=dev)
    got = torch.cat([af._one_pole_card(_on_card(x[:, i:j].copy(), dev),
                                       mode, 0.9, 0.4, state=st_c)
                     for i, j in ((0, 1037), (1037, 1038), (1038, 3096))],
                    1)
    st_p = torch.zeros((41, 2), dtype=torch.float32)
    want = (af.one_pole_cascade(xt, 0.9, 0.4, state=st_p) if mode == 2
            else af.one_pole(xt, 0.9, bool(mode), state=st_p))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(st_c.cpu(), st_p)
    with pytest.raises(ValueError):
        af._one_pole_card(_on_card(x, dev), mode, 0.9, 0.4,
                          state=torch.zeros((40, 2), device=dev))


@pytest.mark.cuda
def test_k8_takes_an_unaligned_view_and_refuses_bad_input():
    dev = _card()
    x = _audio(16, 2048, seed=3)
    buf = torch.zeros(x.size + 1, dtype=torch.float32, device=dev)
    buf[1:] = torch.as_tensor(x.ravel(), device=dev)
    view = buf[1:].view(x.shape)                  # 4 bytes off alignment
    got = af.one_pole(view, 0.8, diff=True)
    assert torch.equal(got.cpu(), af.one_pole_plain(torch.as_tensor(x), 0.8,
                                                    diff=True))
    assert torch.equal(af.one_pole(torch.as_tensor(x, device=dev)[:, ::2],
                                   0.5).cpu(),
                       af.one_pole_plain(torch.as_tensor(x)[:, ::2], 0.5))
    with pytest.raises(ValueError):
        af.one_pole(torch.zeros(2, 3, 4, device=dev), 0.5)
    with pytest.raises(ValueError):
        af.one_pole(torch.zeros(2, 8, dtype=torch.float64, device=dev), 0.5)


@pytest.mark.cuda
def test_condition_audio_on_card_matches_cpu():
    dev = _card()
    x = _audio(8, 3000, seed=4)
    for deemph, lpf, gain in (("nfm", 3400, 0.0), ("50", 0, 30.0),
                              ("off", 2500, 0.0)):
        got = af.condition_audio(torch.as_tensor(x, device=dev), deemph,
                                 lpf, gain)
        want = af.condition_audio(torch.as_tensor(x), deemph, lpf, gain)
        assert torch.equal(got.cpu(), want)


# path → (samples per symbol, block dibits, leads of the two blocks,
# channels inverted)
PATHS = {"ysf": (10, 7200, ((0, 41), (96, 7)), ()),
         "dpmr": (20, 3600, ((0, 41), (96, 7)), (1,)),
         "edacs": (5, 9600, ((3, 41), (96, 20)), (1,))}
MODULATORS = {"ysf": ysf_encode, "dpmr": dpmr_encode,
              "edacs": edacs_encode}


def _blocks(kind):
    sps, n_dib, leads, inverted = PATHS[kind]
    tv = params.load_burst(kind, "cpu").test_vector()
    out = []
    for i, ls in enumerate(leads):
        x = vector_block(tv, ls, (1 + 2 * i, 2 + 2 * i), n_dib * sps,
                         sps=sps, modulate=MODULATORS[kind].fm_iq,
                         lead_dibits=tv["lead"])
        x[list(inverted), :, 1] *= -1.0         # the FM negated
        out.append(x)
    return out


def _pipe(kind, where, fmt="f16"):
    if kind == "ysf":
        return BatchedYsfVoicePipeline(
            2, pcm_fmt=fmt, device=where,
            tables=params.load_burst(kind, where))
    if kind == "dpmr":
        return BatchedDpmrVoicePipeline(
            2, pcm_fmt=fmt, device=where,
            tables=params.load_burst(kind, where))
    pipe = BatchedEdacsControlPipeline(2, device=where)
    pipe.ctxs[0].state.edacs_ea = True          # channel 0 read as EA
    return pipe


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ysf", "dpmr"])
def test_voice_path_on_card_matches_cpu(kind):
    dev = _card()
    card, cpu = _pipe(kind, dev), _pipe(kind, "cpu")
    for x in _blocks(kind):
        got = card.fetch_pcm(card.decode_block_async(
            torch.as_tensor(x, device=dev)))
        want = cpu.decode_block(x)
        a, b = card.last_frames, cpu.last_frames
        for u, v in zip(a[:2], b[:2]):
            assert torch.equal(u.cpu(), v)
        for u, v in zip(a[2:4] + a[4], b[2:4] + b[4]):
            np.testing.assert_array_equal(u, v)
        peak = float(np.abs(want).max())
        assert got.shape == want.shape and peak > 0
        assert float(np.abs(got - want).max()) <= 2e-3 * peak


@pytest.mark.cuda
def test_edacs_monitor_on_card_matches_cpu():
    dev = _card()
    card, cpu = _pipe("edacs", dev), _pipe("edacs", "cpu")
    for x in _blocks("edacs"):
        n_card = card.decode_block_events(torch.as_tensor(x, device=dev))
        assert n_card == cpu.decode_block_events(x) and n_card >= 2 * 30
        for u, v in zip(card.last_frames, cpu.last_frames):
            np.testing.assert_array_equal(u, v)
    for c in range(2):
        assert ([(e.line, e.pos) for e in card.events(c)]
                == [(e.line, e.pos) for e in cpu.events(c)])
    assert any(e.line.startswith("Sync: -EDACS") for e in card.events(1))
