"""The trunked fleet's other modes in the PyTorch port against the JAX
package's, on the CPU, each on a 768 kHz band of ``data/fleet_tables.npz``
(``engine.fleetvec``), two 1 s blocks: DMR Tier III with a
``ChannelMap`` and without one (the grant stays unresolved), NXDN48,
EDACS with an analog voice row, P25 Phase 1 with two Phase 2 rows
granted both slots of a TDMA channel, ``mode="p25p2"`` on a Phase 2
TDMA control channel, and the ``p2_rows`` guard.

Each fleet is held to the JAX fleet on the same band: ``stats``, the log
lines, the offsets, the calls, each CC context's events, and the PCM
(and the Phase 2 rows' PCM) within 2e-3 of its peak.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.engine import fleettrunk as J
from dsdneo_tpu.engine.trunk import ChannelMap as JMap
from dsdneo_tpu_torch.engine import fleettrunk as P
from dsdneo_tpu_torch.engine import fleetvec as FV
from dsdneo_tpu_torch.engine import serialvec as SV
from dsdneo_tpu_torch.engine.trunk import ChannelMap as PMap
from dsdneo_tpu_torch.protocol.p25 import encode as PE

FS = FV.MODE_FS
B = int(FS)
# mode → (band centre, the granted channel number or None, expected TG)
MODES = {"dmr": (460_000_000.0, 24, 101), "nxdn48": (451_000_000.0, 0x0A5,
                                                     200),
         "edacs": (860_000_000.0, 7, 0x155)}
P2_CENTER = 851_000_000.0
WACN, SYSID, NAC = 0x92065, 0x0D5, 0x293


def _blocks(wide):
    x = wide.numpy() if hasattr(wide, "numpy") else wide
    return [x[i * B:(i + 1) * B] for i in range(len(x) // B)]


def _pair(blocks, kw_j, kw_p, cc_offs):
    out = {}
    for name, cls, kw in (("jax", J.TrunkedFleet, kw_j),
                          ("port", P.TrunkedFleet, dict(kw_p,
                                                        device="cpu"))):
        f = cls(FS, cc_offs, **kw)
        pcm, pcm2 = [], []
        for b in blocks:
            pcm.append(f.step(b))
            pcm2.append(f.p2_pcm)
        out[name] = (f, pcm, pcm2)
    return out


def _close(a, b):
    a = np.asarray(a)
    assert a.shape == b.shape
    if a.size and np.abs(a).max() > 0:
        assert np.abs(a - b).max() <= 2e-3 * np.abs(a).max()
    else:
        assert not np.abs(b).max(initial=0.0)


def assert_equal(out):
    jf, pj, pj2 = out["jax"]
    pf, pp, pp2 = out["port"]
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(jf.stats)
    assert pf.log == jf.log
    assert pf.offs.tolist() == jf.offs.tolist()
    assert {k: (c.tg, c.src, c.freq_hz) for k, c in pf.calls.items()} == \
        {k: (c.tg, c.src, c.freq_hz) for k, c in jf.calls.items()}
    assert {k: (c.tg, c.src, c.freq_hz) for k, c in pf.calls2.items()} == \
        {k: (c.tg, c.src, c.freq_hz) for k, c in jf.calls2.items()}
    for c in range(jf.n_cc):
        assert SV.events_equal(jf.cc_pipe.ctxs[c].events,
                               pf.cc_pipe.ctxs[c].events) is None
    for a, b in zip(pj + pj2, pp + pp2):
        _close(a, b)
    return pf, pp, pp2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_grant_retargets_row_against_jax(mode):
    tv = FV.vector()
    center, ch, tg = MODES[mode]
    cc_off, vc_off = tv[f"{'nxdn' if mode == 'nxdn48' else mode}_offs"]
    band = FV.BANDS[mode](tv)
    maps = []
    for cls in (JMap, PMap):
        cm = cls()
        cm.entries[ch] = center + vc_off
        maps.append(cm)
    kw = dict(n_voice_rows=2, center_hz=center, mode=mode)
    out = _pair(_blocks(band), dict(kw, chan_map=maps[0]),
                dict(kw, chan_map=maps[1]), [int(cc_off)])
    pf, pp, _ = assert_equal(out)
    assert pf.stats.grants == 1 and pf.calls[0].tg == tg
    assert pf.offs[pf.n_cc] == vc_off and pf.offs[pf.n_cc + 1] == cc_off
    e = np.abs(pp[1]).mean(axis=1)
    assert e[0] > 1e-3 and e[1] < e[0] / 10
    if mode == "edacs":
        assert pf.calls[0].src == 77
        assert np.abs(pp[1][1]).max() == 0
        row = pp[1][0].astype(np.float64)
        spec = np.abs(np.fft.rfft(row * np.hanning(row.size)))
        f = np.fft.rfftfreq(row.size, 1 / 8000.0)
        assert abs(f[np.argmax(spec[5:]) + 5] - FV.EDACS_TONE_HZ) < 10.0


def test_dmr_grant_unresolved_without_chan_map():
    tv = FV.vector()
    center = MODES["dmr"][0]
    blocks = _blocks(FV.dmr_band(tv))[:1]
    kw = dict(n_voice_rows=1, center_hz=center, mode="dmr")
    out = _pair(blocks, kw, kw, [int(tv["dmr_offs"][0])])
    pf, _pp, _ = assert_equal(out)
    assert pf.stats.grants == 0 and pf.stats.unresolved >= 1
    assert not pf.calls


def test_p1_cc_grants_p2_rows_against_jax():
    tv = FV.vector()
    kw = dict(n_voice_rows=1, p2_rows=2, center_hz=P2_CENTER)
    out = _pair(_blocks(FV.p2_band(tv)), kw, kw, [int(tv["p2_offs"][0])])
    pf, _pp, pp2 = assert_equal(out)
    assert pf.stats.grants == 2
    assert set(pf.calls2) == {(0, 0), (0, 1)} and not pf.calls
    assert pf.vc2_pipe.params == (WACN, SYSID, NAC)
    assert pf.offs[pf.n_cc + pf.n_vc] == tv["p2_offs"][1]
    assert pf.offs[pf.n_cc + pf.n_vc + 1] == tv["p2_offs"][0]
    e = np.abs(pp2[1]).mean(axis=1)
    assert (e[:2] > 1e-3).all() and (e[2:] < e[:2].min() / 10).all()
    assert any(line.endswith("P2 pipeline up: WACN 92065 SYS 0D5 NAC 293")
               for line in pf.log)


def _p2cc_band():
    """A Phase 2 TDMA control channel at −96 kHz (IDEN_UP TDMA based at
    the band centre, the grant of TG 301 on channel 0x1028: slot 0 of
    +125 kHz, NET_STS) and the Phase 2 voice of ``fleet_tables`` there."""
    tv = FV.vector()

    def msgs(sf, g):
        if g % 4 == 1:
            return [PE.p2_mac_iden_up_tdma(1, P2_CENTER, 6250.0)]
        if g % 4 == 2:
            return [PE.p2_mac_group_grant((1 << 12) | 40, 301, 7001)]
        return [PE.p2_mac_net_sts(WACN, SYSID)]
    cc = PE.p2_cc_iq(PE.p2_cc_superframes(6, WACN, SYSID, NAC, msgs),
                     seed=1)
    vc = PE.tdma_fm_iq(tv["p2_vc_dibits"], 8).astype(np.complex64)
    return FV.place([(cc, -96_000), (vc, 125_000)], FS, 2 * B)


def test_p25p2_mode_against_jax():
    kw = dict(n_voice_rows=2, center_hz=P2_CENTER, mode="p25p2",
              p2_params=(WACN, SYSID, NAC))
    out = _pair(_blocks(_p2cc_band()), kw, kw, [-96_000])
    pf, pp, pp2 = assert_equal(out)
    assert pf.n_vc == 0 and pf.n_vc2 == 2 and pp[1].shape == (0, 0)
    assert pf.stats.grants == 1 and (0, 0) in pf.calls2
    assert pf.offs[pf.n_cc] == 125_000
    assert np.abs(pp2[1][0]).mean() > 1e-3


def test_p2_rows_require_a_p25_mode():
    for cls, kw in ((J.TrunkedFleet, {}), (P.TrunkedFleet,
                                          {"device": "cpu"})):
        with pytest.raises(ValueError):
            cls(FS, [0], n_voice_rows=1, p2_rows=1, mode="dmr", **kw)


def test_channel_map_import_and_fill(tmp_path):
    csv = tmp_path / "chan.csv"
    csv.write_text("channel,frequency\n1,451000000\n4,451037500\n"
                   "x,bad\n7,451075000\n9,0\n")
    for cls in (JMap, PMap):
        cm = cls()
        assert cm.import_csv(str(csv)) == 3
        assert cm.heuristic_fill() == 4
        assert cm.freq(5) == 451050000 and cm.freq(9) is None
    both = [cls() for cls in (JMap, PMap)]
    for cm in both:
        cm.entries.update({1: 451_000_000.0, 3: 451_000_500.0})
        assert cm.heuristic_fill() == 0
    assert both[0].entries == both[1].entries
