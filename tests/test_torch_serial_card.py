"""The serial decode path on the card against the port's CPU path.

``decode_samples`` on ~4 s of each stream of ``data/serial_tables.npz``
(the P25 Phase 1 call as C4FM and as CQPSK with its keyed superframes,
the EDACS/ProVoice stream in the ``provoice`` mode, the DMR stream
upright and on an inverted channel with ``force_polarity``, the X2-TDMA
stream, the NXDN stream as NXDN48 and NXDN96, the dPMR, YSF, D-STAR and
M17 streams, the P25p2 stream with its parameters and blind) on the card
and on the CPU: the same event lines, positions and fields (IMBE,
IMBE-7100 and AMBE bits bit for bit), the same voice parameter bits
(M17: the payloads handed to Codec2 and the IP frames), the card's
decode holding the vector (``engine.serialvec`` judges), and each slot's
PCM within 2e-3 of the CPU path's peak (the voice paths' bound; M17's
Codec2 PCM where libcodec2 loads, which the test reports when it does
not).  ``decode_samples(..., "auto")`` on three families' probes and
``decode_capture`` of a 96 kHz capture, the card against the CPU.

``demod_cqpsk_path`` on the card with its automatic window count
(``cfo_windows > 1``: one window per 0.25 s), with ``DSD_NEO_TED_GAIN``
and with the carried estimate of ``DSD_NEO_COSTAS_DAMPING``
(``cfo_prior``): the soft symbols within 5e-3 of the CPU path's (the
card's cos and sin of phases up to ~10^6 rad round otherwise than the C
library's), the dibits equal off the slicer's thresholds, and the carried
estimate within 0.5 Hz.

Every test needs a card (``cuda`` marker; skips without one) and none
imports JAX, so this file runs on the card's machine:
``python -m pytest --noconftest -q -m cuda tests/test_torch_*.py``.
The CPU path is held to the JAX package by ``test_torch_serial.py``.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch.dsp.resampler import resample
from dsdneo_tpu_torch.engine import decoder, demod
from dsdneo_tpu_torch.engine import serialvec as SV
from dsdneo_tpu_torch.io import IqMetadata, write_iq_capture
from dsdneo_tpu_torch.runtime import config as rtcfg

PCM_REL = 2e-3
SOFT_TOL = 5e-3
EDGE = 0.05


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["c4fm", "cqpsk", "provoice", "dmr",
                                    "dmr_inverted", "x2tdma", "nxdn48",
                                    "nxdn96", "dpmr", "ysf", "dstar", "m17",
                                    "p25p2", "p25p2_blind"])
def test_decode_samples_card_against_cpu(stream):
    dev = _card()
    tv = SV.vector()
    judge_kw = {}
    if stream == "m17":
        n = 4 * 4800
        x, mode, kw = SV.m17_iq(tv, n), "m17", {
            "state_attrs": SV.m17_attrs(tv)}
        from dsdneo_tpu_torch.vocoder import codec2
        if not codec2.available():
            warnings.warn("libcodec2 does not load here: M17 is judged on "
                          "its Codec2 payload bits and emits no PCM")
    elif stream.startswith("p25p2"):
        n = 4 * 6000
        blind = stream == "p25p2_blind"
        x, mode = SV.p2_iq(tv, n), "p25p2"
        kw = {"p2_params": None if blind else SV.p2_params(tv)}
        judge_kw = {"blind": blind}
    elif stream == "provoice":
        n = 4 * 9600
        x, mode, kw = SV.pv_iq(tv, n), "provoice", {}
    elif stream.startswith("dmr"):
        n = 4 * 4800
        inv = stream == "dmr_inverted"
        x, mode = SV.dmr_iq(tv, n, invert=inv), "dmr"
        kw = {"state_attrs": {"dmr_bp_key_id": int(tv["dmr_ids"][4]),
                              **({"force_polarity": {"dmr": True}}
                                 if inv else {})}}
    elif stream == "x2tdma":
        n = 4 * 6000
        x, mode, kw = SV.x2_iq(tv, n), "x2tdma", {}
    elif stream.startswith("nxdn"):
        n = 4 * 48000 // SV.NXDN_SPS[stream]
        x, mode, kw = SV.nxdn_iq(tv, n, stream), stream, {}
    elif stream == "dpmr":
        n = 4 * 2400
        x, mode, kw = SV.dpmr_iq(tv, n), "dpmr", {}
    elif stream == "ysf":
        n = 4 * 4800
        x, mode, kw = SV.ysf_iq(tv, n), "ysf", {}
    elif stream == "dstar":
        n = 4 * 4800
        x, mode, kw = SV.dstar_iq(tv, n), "dstar", {}
    else:
        n = 4 * 4800
        x = SV.p25_iq(tv, n, cqpsk=stream == "cqpsk")
        mode, kw = "p25p1", {"cqpsk": stream == "cqpsk"}
    gc, gs = SV.decode_spied(x, mode, keyring=SV.keyring(tv), device=dev,
                             **kw)
    cc, cs = SV.decode_spied(x, mode, keyring=SV.keyring(tv),
                             device="cpu", **kw)
    assert SV.events_equal(cc.events, gc.events) is None, \
        SV.events_equal(cc.events, gc.events)
    assert SV.sinks_equal(cs, gs)
    got = SV.judge(mode, tv, gc, gs, n, invert=stream == "dmr_inverted",
                   **judge_kw)
    key, least = {"provoice": ("provoice_superframes", 15),
                  "m17": ("voice_frames", 60),
                  "p25p2": ("voice_frames", 300),
                  "dmr": ("bp_frames", 72), "x2tdma": ("superframes", 12),
                  "nxdn48": ("vcalls", 10), "nxdn96": ("vcalls", 10),
                  "dpmr": ("fs3_parts", 11), "ysf": ("imbe_frames", 30),
                  "dstar": ("superframes", 7),
                  "p25p1": ("keyed_ldus", 8)}[mode]
    assert got[key] >= least
    assert sorted(cc.audio) == sorted(gc.audio)
    for slot in cc.audio:
        a, b = SV.pcm(cc, slot), SV.pcm(gc, slot)
        assert a.shape == b.shape
        if stream == "m17":
            # libcodec2's noise generator is one for the whole process:
            # each decode in a fresh process
            a, b = SV.m17_pcm_fresh(n, "cpu"), SV.m17_pcm_fresh(n, "cuda")
            assert a.shape == b.shape
        if a.size:
            assert np.isfinite(b).all() and np.abs(b).max() > 0.05
            assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()


@pytest.mark.cuda
def test_demod_cqpsk_path_windows_and_knobs_on_the_card(monkeypatch):
    dev = _card()
    tv = SV.vector()
    x = SV.p25_iq(tv, 6 * 4800, cqpsk=True)          # 6 s: 24 windows
    monkeypatch.setenv("DSD_NEO_TED_GAIN", "1.3")
    monkeypatch.setenv("DSD_NEO_COSTAS_DAMPING", "1.5")
    emas = []
    for d in ("cpu", dev):
        monkeypatch.setattr(rtcfg, "_config", None)
        monkeypatch.setattr(demod.demod_cqpsk_path, "_cfo_ema", 120.0,
                            raising=False)
        out = demod.demod_cqpsk_path(x, "p25p1", device=d)
        emas.append(demod.demod_cqpsk_path._cfo_ema)
        if d == "cpu":
            cd, cs = out
        else:
            gd, gs = out
    assert rtcfg.get().cfo_windows == 0           # the automatic count
    assert abs(emas[0] - emas[1]) <= 0.5
    assert np.abs(cs - gs).max() <= SOFT_TOL
    off = np.min(np.abs(np.abs(cs)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    np.testing.assert_array_equal(cd[off], gd[off])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["p25p1", "m17", "p25p2"])
def test_auto_mode_card_against_cpu(family):
    dev = _card()
    tv = SV.vector()
    x = {"p25p1": lambda: SV.p25_iq(tv, 4 * 4800),
         "m17": lambda: SV.m17_iq(tv, 4 * 4800),
         "p25p2": lambda: SV.p2_iq(tv, 4 * 6000)}[family]()
    kw = {"state_attrs": SV.m17_attrs(tv), "keyring": SV.keyring(tv)}
    gc = decoder.decode_samples(x, "auto", device=dev, **kw)
    cc = decoder.decode_samples(x, "auto", device="cpu", **kw)
    assert gc.mode_name == cc.mode_name == family
    assert SV.events_equal(cc.events, gc.events) is None, \
        SV.events_equal(cc.events, gc.events)


@pytest.mark.cuda
def test_decode_capture_card_against_cpu(tmp_path):
    dev = _card()
    tv = SV.vector()
    n = 4 * 4800
    x = resample(torch.from_numpy(SV.p25_iq(tv, n)), 48000, 96000).numpy()
    path = os.path.join(str(tmp_path), "p25_96k.iq")
    write_iq_capture(path, 0.5 * x, IqMetadata(sample_format="cs16",
                                                sample_rate_hz=96000))
    out = []
    for d in (dev, "cpu"):
        sink = SV.ImbeSink()
        ctx = decoder.decode_capture(path, "p25p1", keyring=SV.keyring(tv),
                                     mbe_sink=sink, device=d)
        out.append((ctx, sink))
    (gc, gs), (cc, cs) = out
    assert SV.events_equal(cc.events, gc.events) is None, \
        SV.events_equal(cc.events, gc.events)
    got = SV.judge_p25(tv, gc, gs, n)
    assert got["ldus"] >= 18
    a, b = SV.pcm(cc), SV.pcm(gc)
    assert a.shape == b.shape and np.abs(a - b).max() <= PCM_REL * np.abs(
        a).max()
