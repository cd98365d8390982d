"""The AMBE voice paths on the card against the port's own CPU path, two
channels, two blocks with the carry kept: X2-TDMA, P25 Phase 2, NXDN48
and NXDN96 upright, and the inverted-polarity streams of NXDN and DMR;
and P25 Phase 2 with ADP encryption at 64 channels (kernel K7 in the
ESS screen), judged against the plaintext, its channels 0-1 against the
CPU path.

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
The CPU path is held to the JAX package by ``test_torch_x2.py``,
``test_torch_p2.py``, ``test_torch_nxdn.py`` and
``test_torch_dmrbatch.py``.  Held here: the same accepted frames, the
same AMBE bits and error counts, and the PCM within 2e-3 of its peak
(K1 on the card reads its input in another summation order, so a soft
symbol may land on the other side of a slicer threshold: the bits must
still agree on these blocks).
"""

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.crypto.keyring import KeyRing
from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
from dsdneo_tpu_torch.engine.nxdnbatch import BatchedNxdnVoicePipeline
from dsdneo_tpu_torch.engine.p2batch import BatchedP2VoicePipeline
from dsdneo_tpu_torch.engine.x2batch import BatchedX2VoicePipeline
from dsdneo_tpu_torch.fec.device import rs_syndromes_batch
from dsdneo_tpu_torch.protocol.dmr import encode
from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode
from dsdneo_tpu_torch.protocol.p25.encode import tdma_fm_iq

LEADS = ((7, 40), (0, 25))
SEEDS = ((1, 2), (3, 4))

# path → (tables, samples per symbol, block length in symbols, modulator,
# pipeline factory)
PATHS = {
    "x2": ("x2tdma", 8, 5400, tdma_fm_iq,
           lambda dev, t: BatchedX2VoicePipeline(2, device=dev, tables=t)),
    "p2": ("p25p2", 8, 6600, tdma_fm_iq,
           lambda dev, t: BatchedP2VoicePipeline(2, device=dev, tables=t)),
    "nxdn48": ("nxdn48", 20, 12 * 192 + 60, nxdn_encode.modulator("nxdn48"),
               lambda dev, t: BatchedNxdnVoicePipeline(
                   2, mode="nxdn48", device=dev, tables=t)),
    "nxdn96": ("nxdn96", 10, 12 * 192 + 60, nxdn_encode.modulator("nxdn96"),
               lambda dev, t: BatchedNxdnVoicePipeline(
                   2, mode="nxdn96", device=dev, tables=t)),
    "dmr": (None, 10, 5400, encode.dmr_fm_iq,
            lambda dev, t: BatchedDmrVoicePipeline(2, device=dev, tables=t)),
}


def _tables(mode, dev):
    return params.load_dmr(dev) if mode is None else params.load_tdma(
        mode, dev)


def _frames(pipe):
    """(bits, errs, output row, step) of the last block's frames."""
    lf = pipe.last_frames
    if isinstance(pipe, BatchedP2VoicePipeline):
        return lf[0].cpu(), lf[1].cpu(), lf[2][4], lf[2][5]
    return lf[0].cpu(), lf[1].cpu(), lf[2], lf[3]


@pytest.mark.cuda
@pytest.mark.parametrize("path,invert", [
    ("x2", False), ("p2", False), ("nxdn48", False), ("nxdn96", False),
    ("nxdn48", True), ("dmr", True)])
def test_path_on_card_matches_cpu(path, invert):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mode, sps, n_dib, modulate, make = PATHS[path]
    cpu_t, card_t = _tables(mode, "cpu"), _tables(mode, "cuda")
    tv = cpu_t.test_vector()
    xs = [encode.vector_block(tv, LEADS[i], SEEDS[i], n_dib * sps, sps=sps,
                              invert=invert, modulate=modulate)
          for i in range(2)]
    card, cpu = make("cuda", card_t), make("cpu", cpu_t)
    for blk, x in enumerate(xs):
        got = card.decode_block(torch.as_tensor(x, device="cuda"))
        want = cpu.decode_block(x)
        gb, ge, grow, gstep = _frames(card)
        wb, we, wrow, wstep = _frames(cpu)
        np.testing.assert_array_equal(grow, wrow)
        np.testing.assert_array_equal(gstep, wstep)
        assert torch.equal(gb, wb) and torch.equal(ge, we)
        assert len(grow) >= 2 * 2 * 5 * 4
        if invert and path == "dmr":
            assert card.last_superframes[2].all()
        if invert and path.startswith("nxdn"):
            assert card.last_frames[4][2].all()
        peak = float(np.abs(want).max())
        assert got.shape == want.shape and peak > 0
        assert float(np.abs(got - want).max()) <= 2e-3 * peak


def _slot_frames(pipe, row):
    """(bits, errs) of output stream ``row``'s frames in order."""
    bits, errs, arrs, _jobs = pipe.last_frames
    sel = np.flatnonzero(arrs[4] == row)
    sel = sel[np.argsort(arrs[5][sel])]
    return bits.cpu().numpy()[sel], errs.cpu().numpy()[sel]


@pytest.mark.cuda
def test_p2_adp_on_card_at_64_channels():
    """The ADP/RC4 stream with its key at 64 channels (own lead of 0-96
    dibits and noise each), two blocks with the carry kept: every slot
    stream decodes from its second superframe on to the plaintext bits,
    the first block's first superframe stays cipher, K7 launches once a
    block, and channels 0-1 equal the CPU path's frames and PCM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = 64
    cpu_t, card_t = _tables("p25p2", "cpu"), _tables("p25p2", "cuda")
    adp = {k[4:]: v for k, v in cpu_t.test_vector().items()
           if k.startswith("adp_")}
    n_sf, _seed, _alg, kid, key, _mi = (int(v) for v in adp["params"])
    rng = np.random.default_rng(64)
    leads = rng.integers(0, 97, C)
    xs = [encode.vector_block({"dibits": adp["dibits"]}, leads,
                              rng.permutation(1 << 20)[:C],
                              len(adp["dibits"]) * 8, sps=8,
                              modulate=tdma_fm_iq) for _ in range(2)]
    keys = KeyRing()
    keys.scalar[kid] = key
    card = BatchedP2VoicePipeline(C, keyring=keys, device="cuda",
                                  tables=card_t)
    cpu = BatchedP2VoicePipeline(2, keyring=keys, device="cpu",
                                 tables=cpu_t)
    before = rs_syndromes_batch.launches
    for blk, x in enumerate(xs):
        got = card.decode_block(torch.as_tensor(x, device="cuda"))
        want = cpu.decode_block(x[:2])
        for r in range(2 * C):
            bits, _e = _slot_frames(card, r)
            assert len(bits) >= (n_sf - 1) * 18, (blk, r, len(bits))
            np.testing.assert_array_equal(
                bits[18:], adp["bits49"][r % 2][18:len(bits)])
            if blk == 0:
                assert (bits[:18] != adp["bits49"][r % 2][:18]).any()
        for r in range(4):
            gb, ge = _slot_frames(card, r)
            wb, we = _slot_frames(cpu, r)
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(ge, we)
        peak = float(np.abs(want).max())
        assert np.isfinite(got).all() and peak > 0
        n = min(got.shape[1], want.shape[1])
        assert float(np.abs(got[:4, :n] - want[:, :n]).max()) <= 2e-3 * peak
        assert card.last_ess["rs_words"] > 0
    assert rs_syndromes_batch.launches == before + 2
