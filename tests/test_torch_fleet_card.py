"""The wideband band, the trunked fleet and the branches of the P25 voice
path first run on the card here, each against the port's own CPU path:

  - ``BatchedP25VoicePipeline`` on an inverted channel (the conjugate
    I/Q: every sync reads as ``-P25p1``, whose hits the pick drops) and
    with the µ-law wire;
  - the DMR voice pipeline on the ``dmr_iq``-shaped stream, every frame
    exact;
  - ``channelize_os2``, the row extractor (its NCO phase bit for bit),
    ``decode_wideband_voice_batched`` on 16 channels;
  - ``TrunkedFleet`` on the JAX bench's band (host and device pick, the
    CU8 wire, the prefetch path bit for bit against the plain step on
    the card), the DMR, NXDN48, EDACS and Phase 2 row fleets, the device
    pick's body (kernels K1 and K4);
  - ``analog_voice_decode`` and ``FleetMonitor``.

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
Held: events, stats, log lines and offsets equal; PCM within 2e-3 of
its peak; the banks within 1e-6 of their peak, the rows within 2e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.dsp import channelizer
from dsdneo_tpu_torch.engine import fleetvec as FV
from dsdneo_tpu_torch.engine import serialvec as SV
from dsdneo_tpu_torch.engine.fleettrunk import TrunkedFleet, \
    make_row_extractor, nco_phase
from dsdneo_tpu_torch.engine.trunk import ChannelMap
from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def _p25_block(invert=False):
    tv = params.load("cpu").test_vector()
    x = p25_encode.vector_block(tv, (30, 77), (1, 2), 48000)
    if invert:
        x[..., 1] *= -1.0
    return x


def test_p25_voice_inverted_channel_on_card():
    x = _p25_block(invert=True)
    got = {}
    for where in ("cuda", "cpu"):
        pipe = BatchedP25VoicePipeline(2, device=where)
        fe = pipe.frontend_finish(pipe.frontend_dispatch(x))
        h = pipe.decode_from_frontend(fe)
        got[where] = (fe, pipe.fetch_pcm(h), pipe.last_frames)
    (gfe, gpcm, gfr), (cfe, cpcm, cfr) = got["cuda"], got["cpu"]
    # every sync reads inverted: the candidates agree, nothing is taken
    assert (gfe[3][:, :4] == 1).all()
    np.testing.assert_array_equal(gfe[1][:, :16], cfe[1][:, :16])
    assert gfr is None and cfr is None
    assert gpcm.shape == cpcm.shape == (2, 0)


def test_p25_voice_mulaw_wire_on_card():
    x = _p25_block()
    out = {}
    for where in ("cuda", "cpu"):
        pipe = BatchedP25VoicePipeline(2, pcm_fmt="mulaw", device=where)
        h = pipe.decode_block_async(x)
        out[where] = (h.cpu().numpy(), pipe.fetch_pcm(h),
                      pipe.last_frames[0].cpu().numpy())
    (gw, gp, gb), (cw, cp, cb) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(gb, cb)
    assert gw.dtype == np.uint8 and (gw == cw).mean() >= 0.999
    assert np.abs(gp - cp).max() <= 2e-3 * np.abs(cp).max() + 2 ** -7


def test_dmr_c4fm_shaped_stream_on_card():
    from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
    from dsdneo_tpu_torch.protocol.dmr import encode
    tab = params.load_dmr("cuda")
    tv = tab.test_vector()
    pipe = BatchedDmrVoicePipeline(2, tables=tab)
    for blk, leads in enumerate(((7, 40), (0, 25))):
        x = encode.vector_block(
            tv, leads, (2 * blk + 1, 2 * blk + 2), 54000,
            modulate=lambda d, sps: p25_encode.c4fm_clean(
                d, sps, 48000.0, SV.DMR_DEV_HZ))
        pipe.decode_block_async(x)
        bits, errs, fch, _ = pipe.last_frames
        bits, errs = bits.cpu().numpy(), errs.cpu().numpy()
        assert not errs.any()
        for c in range(2):
            _pos, want = encode.expected_frames(tv, leads[c], 5400 - 2)
            np.testing.assert_array_equal(
                bits[np.asarray(fch) == c].reshape(-1, 18, 49), want)


def test_channelizer_and_row_extractor_on_card():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=16 * 20001) + 1j * rng.normal(size=16 * 20001)
         ).astype(np.complex64)
    want = channelizer.channelize_os2(torch.from_numpy(x), 16, 12).numpy()
    got = channelizer.channelize_os2(torch.from_numpy(x).cuda(), 16, 12)
    assert _rel(want, got.cpu().numpy()) <= 1e-6
    offs = torch.tensor([-96000, 150000, 24000, -383999], dtype=torch.int32)
    k, ph = nco_phase(offs, 40000)
    kg, phg = nco_phase(offs.cuda(), 40000)
    assert torch.equal(k, kg.cpu()) and torch.equal(ph, phg.cpu())
    ex = make_row_extractor(16)
    want = ex(torch.from_numpy(x), offs).numpy()
    got = ex(torch.from_numpy(x).cuda(), offs.cuda()).cpu().numpy()
    assert _rel(want, got) <= 2e-6


def test_decode_wideband_voice_batched_on_card():
    from dsdneo_tpu_torch.engine.wideband import \
        decode_wideband_voice_batched
    tv = params.load("cpu").test_vector()
    parts = [(p25_encode.c4fm_iq(p25_encode.vector_stream(tv, 40, 4800),
                                 seed=1), 2 * 48000),
             (p25_encode.c4fm_iq(p25_encode.vector_stream(tv, 57, 4800),
                                 seed=2), -5 * 48000)]
    wide = FV.place(parts, 768000.0, 768000)
    cp, _f = decode_wideband_voice_batched(wide, 768000.0, device="cpu")
    gp, _f = decode_wideband_voice_batched(wide.cuda(), 768000.0)
    assert gp.shape == cp.shape
    assert np.abs(gp - cp).max() <= 2e-3 * np.abs(cp).max()
    assert set(np.flatnonzero(np.abs(gp).mean(axis=1) > 1e-3)) == {2, 11}


def _fleet_pair(blocks, fs, cc_offs, **kw):
    out = {}
    for where in ("cuda", "cpu"):
        f = TrunkedFleet(fs, cc_offs, device=where, **kw)
        out[where] = (f, [f.step(b) for b in blocks])
    (g, gp), (c, cp) = out["cuda"], out["cpu"]
    assert dataclasses.asdict(g.stats) == dataclasses.asdict(c.stats)
    assert g.log == c.log and g.offs.tolist() == c.offs.tolist()
    for i in range(g.n_cc):
        assert SV.events_equal(c.cc_pipe.ctxs[i].events,
                               g.cc_pipe.ctxs[i].events) is None
    for a, b in zip(cp, gp):
        assert a.shape == b.shape
        if a.size and np.abs(a).max() > 0:
            assert np.abs(a - b).max() <= 2e-3 * np.abs(a).max()
    return g, gp


@pytest.mark.parametrize("pick", [False, True])
def test_bench_fleet_on_card(pick):
    band = FV.bench_band(FV.vector())
    blocks = [band[:768000].numpy(), band[768000:].numpy()]
    g, gp = _fleet_pair(blocks, FV.BENCH_FS, [FV.BENCH_CC_OFF],
                        n_voice_rows=4, center_hz=FV.BENCH_CENTER,
                        hangtime_s=5.0, grant_grace_s=0.5,
                        cc_device_pick=pick)
    assert g.stats.grants == 1 and g.offs[1] == FV.BENCH_VC_OFF
    assert np.abs(gp[1][0]).mean() > 1e-3 and not gp[1][1:].any()


def test_bench_fleet_cu8_prefetch_bit_identical_on_card():
    u8 = FV.cu8_planes(FV.bench_band(FV.vector()))
    blocks = [u8[:768000].numpy(), u8[768000:].numpy()]
    kw = dict(n_voice_rows=4, center_hz=FV.BENCH_CENTER, hangtime_s=5.0,
              grant_grace_s=0.5, cc_device_pick=True)
    plain = TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], **kw)
    pre = TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], **kw)
    a = [plain.step(blocks[i % 2]) for i in range(4)]
    b = [pre.step(blocks[0], prefetch=blocks[1])]
    b += [pre.step(None, prefetch=blocks[i % 2]) for i in range(2, 4)]
    b.append(pre.step(None))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert plain.stats == pre.stats and np.abs(a[1][0]).mean() > 1e-3


@pytest.mark.parametrize("mode", ["dmr", "nxdn48", "edacs", "p2"])
def test_mode_fleets_on_card(mode):
    tv = FV.vector()
    key = {"nxdn48": "nxdn"}.get(mode, mode)
    cc_off, vc_off = (int(v) for v in tv[f"{key}_offs"])
    band = FV.BANDS[mode](tv).numpy()
    blocks = [band[:768000], band[768000:]]
    if mode == "p2":
        g, _gp = _fleet_pair(blocks, FV.MODE_FS, [cc_off], n_voice_rows=1,
                             p2_rows=2, center_hz=851e6)
        assert g.stats.grants == 2 and g.offs[2] == vc_off
        assert (np.abs(g.p2_pcm[:2]).mean(axis=1) > 1e-3).all()
        return
    center, ch = {"dmr": (460e6, 24), "nxdn48": (451e6, 0x0A5),
                  "edacs": (860e6, 7)}[mode]
    cm = ChannelMap()
    cm.entries[ch] = center + vc_off
    g, gp = _fleet_pair(blocks, FV.MODE_FS, [cc_off], n_voice_rows=2,
                        center_hz=center, mode=mode, chan_map=cm)
    assert g.stats.grants == 1 and g.offs[1] == vc_off
    assert np.abs(gp[1][0]).mean() > 1e-3


def test_device_pick_body_on_card():
    from dsdneo_tpu_torch.engine import fleettrunk
    from dsdneo_tpu_torch.parallel.mesh import _p25_cc_body
    band = FV.bench_band(FV.vector())[:768000]
    rows = fleettrunk.make_row_extractor(16)(
        band, torch.tensor([FV.BENCH_CC_OFF], dtype=torch.int32))
    planes = torch.view_as_real(rows).contiguous()
    out = {}
    for where in ("cuda", "cpu"):
        body = _p25_cc_body(1, planes.shape[1], 48000.0, 16, 0.62,
                            nac_out=True, dedup=True,
                            tables=params.load_cc("p25", where))
        out[where] = [t.cpu().numpy() for t in body(planes.to(where))]
    (gb, gv, gm), (cb, cv, cm) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_array_equal(gm[gv], cm[cv])
    np.testing.assert_array_equal(gb[gv], cb[cv])
    assert gv.sum() >= 5


def test_analog_and_fleet_monitor_on_card():
    from dsdneo_tpu_torch.engine.analogbatch import analog_voice_decode
    from dsdneo_tpu_torch.engine.fleet import FleetMonitor
    t = np.arange(48000) / 48000.0
    x = np.exp(1j * 2 * np.pi * 2500.0 * np.cumsum(
        np.sin(2 * np.pi * 1000.0 * t)) / 48000.0).astype(np.complex64)
    x = torch.from_numpy(np.stack([x, np.zeros_like(x)]))
    want = analog_voice_decode(x).numpy()
    got = analog_voice_decode(x.cuda()).cpu().numpy()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    block = _p25_block()
    res = []
    for where in ("cuda", "cpu"):
        fleet = FleetMonitor(device=where)
        fleet.assign("p25p1", 2, kind="voice", freqs=[851e6, 852e6])
        fleet.decode_block(block)
        res.append((fleet.groups[0].pcm, fleet.channel_dicts()))
    assert res[0][1] == res[1][1]
    assert np.abs(res[0][0] - res[1][0]).max() <= \
        2e-3 * np.abs(res[1][0]).max()
