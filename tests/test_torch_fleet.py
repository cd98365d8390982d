"""The mixed-protocol fleet (``engine/fleet.FleetMonitor``) of the
PyTorch port against the JAX package's, on the CPU: the cases of
``tests/test_fleet.py`` on the port's vectors instead of the absent
captures.  Three P25 voice channels and two P25 control channels in
one block (voice PCM per group, events per control channel, the channel
grid), P25 and DMR control groups side by side, and an NXDN96 control
group built on the 9600-baud front end.  The PCM is held within 2e-3 of
its peak, the events (lines, positions, fields) and the grid's rows
equal.
"""

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.engine import fleet as J
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import fleet as P
from dsdneo_tpu_torch.engine import serialvec as SV
from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode
from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean

N = 22000            # samples a channel: 2200 symbols at 4800/s


def _cc_rows(kind, leads, seeds):
    tv = params.load_cc(kind, "cpu").test_vector()
    modulate = ((lambda d, sps: c4fm_clean(d, sps)) if kind == "p25"
                else dmr_encode.dmr_fm_iq)
    return dmr_encode.vector_block(tv, leads, seeds, N, sps=10,
                                   modulate=modulate,
                                   lead_dibits=tv["lead"])


def _voice_rows(leads, seeds):
    tv = params.load("cpu").test_vector()
    return p25_encode.vector_block(tv, leads, seeds, N)


def _pair(groups, block):
    out = []
    for fleet in (J.FleetMonitor(fs=48000.0),
                  P.FleetMonitor(fs=48000.0, device="cpu")):
        for mode, count, kind, freqs in groups:
            fleet.assign(mode, count, kind=kind, freqs=freqs)
        fleet.decode_block(block)
        out.append(fleet)
    return out


def _events(fleet, ch):
    return fleet.events(ch)


def test_fleet_mixed_voice_and_cc():
    block = np.concatenate([_voice_rows((30, 77, 120), (1, 2, 3)),
                            _cc_rows("p25", (5, 60), (4, 5))])
    jf, pf = _pair([("p25p1", 3, "voice", [851e6, 852e6, 853e6]),
                    ("p25p1", 2, "cc", [854e6, 855e6])], block)
    assert pf.total_channels == 5
    gv = pf.groups[0]
    want = np.asarray(jf.groups[0].pcm)
    assert gv.pcm.shape == want.shape and gv.pcm.shape[0] == 3
    assert np.abs(gv.pcm - want).max() <= 2e-3 * np.abs(want).max()
    assert np.abs(gv.pcm).max() > 1e-4
    for ch in (3, 4):
        assert SV.events_equal(_events(jf, ch), _events(pf, ch)) is None
    assert any("TSDU" in e.line for e in pf.events(3))
    assert pf.events(0) == []
    with pytest.raises(IndexError):
        pf.events(5)
    chans = pf.channel_dicts()
    assert chans == jf.channel_dicts()
    assert len(chans) == 5 and chans[0]["state"] == "voice"
    assert chans[3]["state"] == "cc" and chans[0]["freq_hz"] == 851e6


def test_fleet_multi_protocol_groups():
    block = np.concatenate([_cc_rows("p25", (33,), (7,)),
                            _cc_rows("dmr", (47,), (8,))])
    jf, pf = _pair([("p25p1", 1, "cc", None), ("dmr", 1, "cc", None)],
                   block)
    for ch in (0, 1):
        assert SV.events_equal(_events(jf, ch), _events(pf, ch)) is None
    assert any("TSDU" in e.line for e in pf.events(0))
    assert any("CSBK" in e.line for e in pf.events(1))
    assert pf.channel_dicts() == jf.channel_dicts()


def test_fleet_nxdn96_cc_group_uses_9600_frontend():
    fleet = P.FleetMonitor(fs=48000.0, device="cpu")
    g = fleet.assign("nxdn96", 1, kind="cc")
    assert g.pipeline.cc.kind == "nxdn96"
    assert g.pipeline.ctxs[0].mode_name == "nxdn96"
    assert g.pipeline.cc.front.symbol_rate == 4800
    g48 = fleet.assign("nxdn48", 1, kind="cc")
    assert g48.pipeline.cc.front.symbol_rate == 2400
    with pytest.raises(ValueError):
        fleet.assign("analog", 1)


def test_fleet_takes_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        P.FleetMonitor()
