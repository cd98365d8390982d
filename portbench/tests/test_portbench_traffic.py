"""The generator repeats exactly for a seed, differs between seeds, and
keys the channels and LDUs each traffic file asks for."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.inputs import c4fm, c4fm_channels
from portbench.reference import p25_chain

TV = c4fm.test_vector()
SMALL = {"channels": 8, "block_s": 0.5}
SMALL_BAND = {"channels": 16, "block_s": 0.5, "band_fs": 768000.0}


def _cell(name):
    return harness.resolve(harness.load_spec(), name)


@pytest.mark.parametrize("cell,cfg,mix", [
    ("p25.keyed", SMALL, {"ring": 2}),
    ("p25.keyed", SMALL, {"ring": 2, "keyed": {"all_but": [1, 6]}}),
    ("wideband.keyed", SMALL_BAND, {"ring": 1, "keyed": {"all_but": [3, 8]}}),
    ("wideband.keyed", SMALL_BAND, {"ring": 2, "keyed": {"all": True}}),
], ids=["p25", "p25-all_but", "band", "band-all"])
def test_ring_repeats_for_a_seed_and_differs_between_seeds(cell, cfg, mix):
    w = _cell(cell)
    c = dict(w.cfg, **cfg)
    m = dict(w.mix, **mix)
    a, ia = w.inputs.make_ring(c, m, 2 ** 31 + 11, "cpu", pin=False)
    b, ib = w.inputs.make_ring(c, m, 2 ** 31 + 11, "cpu", pin=False)
    d, _ = w.inputs.make_ring(c, m, 2 ** 31 + 12, "cpu", pin=False)
    assert len(a) == m["ring"]
    for x, y, z in zip(a, b, d):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
    for p, q in zip(ia, ib):
        assert np.array_equal(p.keyed, q.keyed)
        assert np.array_equal(p.leads, q.leads)


@pytest.mark.parametrize("cell,n_units", [
    ("p25.keyed", 320), ("wideband.keyed", 256)])
def test_keyed_sets_follow_the_traffic_file(cell, n_units):
    w = _cell(cell)
    keyed = w.mix["keyed"]
    lo, hi = w.mix["lead_dibits"]
    leads = set()
    for b in range(w.mix["ring"]):
        info = c4fm.draw(w.cfg, w.mix, 987654321987, b, n_units)
        if keyed.get("all"):
            assert np.array_equal(info.keyed, np.arange(n_units))
        else:
            assert set(info.keyed) == set(range(n_units)) - set(
                keyed["all_but"])
        assert np.all((info.leads >= lo) & (info.leads <= hi))
        leads.add(tuple(info.leads))
    assert len(leads) == w.mix["ring"]        # drawn anew per block


def test_an_unknown_keyed_set_is_refused():
    with pytest.raises(ValueError):
        c4fm.draw({}, {"keyed": {"count": 3}, "lead_dibits": [0, 1]}, 1, 0,
                   8)


def test_every_keyed_channel_holds_all_sixteen_ldus():
    """The block holds every LDU of the call whole at any lead the mixes
    draw, so every seed gives the same work."""
    n_sym = int(3.0 * 4800) - 2
    need = p25_chain.P25Chain(1)._ldu_need
    for lead in (0, 128, 256):
        k = int(np.sum(lead + TV["ldu_starts"] + need < n_sym))
        assert k == 16


def test_a_keyed_channel_decodes_the_vector():
    """On the CPU, the plain chain decodes the generator's channel into
    the vector's frames; an unkeyed channel (noise only) into none."""
    w = _cell("p25.keyed")
    c = dict(w.cfg, channels=2, block_s=1.0)
    info = c4fm.BlockInfo(np.array([0]), np.array([37]))
    x = c4fm_channels.channel_block(c, TV, info, 5, 0, "cpu", 48000)
    ch = p25_chain.P25Chain(2, device="cpu")
    frames, _wire, _carry, _s = ch.decode(ch.frontend(x), None)
    bits, _e, fch, forder, margin = frames
    # 30 dB: no dibit near a threshold
    assert (margin >= p25_chain.MARGINAL).all()
    n_sym = 4800 - 2
    want = TV["bits88"][:9 * int(np.sum(37 + TV["ldu_starts"]
                                        + ch._ldu_need < n_sym))]
    assert set(fch.tolist()) == {0}
    assert np.array_equal(bits[np.argsort(forder)], want)


def test_traffic_files_are_data():
    """Every mix holds what the harness reads of it; the mixes of the
    configurations whose generator draws its keyed set as the C4FM ones
    do (``c4fm.draw``) hold what that draw reads."""
    spec = harness.load_spec()
    c4fm_mixes = {w["traffic"] for w in spec["workloads"]
                  if getattr(_cell(w["name"]).inputs, "draw", None)
                  is c4fm.draw}
    assert c4fm_mixes
    d = os.path.join(harness.PKG, "traffic")
    for f in os.listdir(d):
        assert f.endswith(".json")
        with open(os.path.join(d, f)) as fh:
            m = json.load(fh)
        assert {"ring", "why"} <= set(m), f
        if f[:-len(".json")] in c4fm_mixes:
            assert {"keyed", "lead_dibits"} <= set(m), f
