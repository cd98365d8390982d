"""The port's live one-tuner path against the JAX package's, on the CPU:
the ingest ring (``runtime.native.IngestRing``, built from
``dsdneo_tpu_torch/csrc/ingest_ring.cpp``), ``engine.stream.
StreamDecoder``, ``engine.live.LiveEngine`` in lockstep, the closed loop
of ``engine/livevec`` (``TrunkFollower`` + ``TrunkSM`` retuning one
tuner between the bench's control channel and its granted call), and
the socket plumbing (``io.rtl_tcp`` into the ring and ``LiveEngine``;
the CLI's socket inputs are in ``test_torch_cli_stream.py``).

Equal means: the ring's float planes bit for bit and its counters
equal; events equal in line, protocol, position and fields; PCM within
2e-3 of its peak; the capture journal's bytes and sidecar equal.  In
lockstep no thread runs: a test feeds CU8 bytes and then calls
``run(max_blocks=...)``, so the block boundaries are the same in both
packages.
"""

import json
import os
import socket
import time

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.engine import live as JL  # noqa: E402
from dsdneo_tpu.engine import stream as JS  # noqa: E402
from dsdneo_tpu.engine import trunk as JT  # noqa: E402
from dsdneo_tpu.io import iq as JIQ  # noqa: E402
from dsdneo_tpu.runtime import native as JN  # noqa: E402
from dsdneo_tpu_torch.engine import fleetvec as FV  # noqa: E402
from dsdneo_tpu_torch.engine import live as PL  # noqa: E402
from dsdneo_tpu_torch.engine import livevec as LV  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.engine import stream as PS  # noqa: E402
from dsdneo_tpu_torch.engine import trunk as PT  # noqa: E402
from dsdneo_tpu_torch.io import iq as PIQ  # noqa: E402
from dsdneo_tpu_torch.io import rtl_tcp as PR  # noqa: E402
from dsdneo_tpu_torch.runtime import native as PN  # noqa: E402

PCM_REL = 2e-3
CHUNK = 12000                       # 0.25 s at 48 kHz


# -- the ingest ring ------------------------------------------------------------
def test_ingest_ring_against_jax():
    rng = np.random.default_rng(19)
    data = rng.integers(0, 256, 40001, dtype=np.uint8).tobytes()
    rings = {"jax": JN.IngestRing(1 << 14), "port": PN.IngestRing(1 << 14)}
    log = {}
    for name, r in rings.items():
        out = []
        # an odd first write: the dangling byte waits for the next one
        out.append(("w", r.write(data[:4097]), r.fill))
        out.append(("w", r.write(data[4097:8192]), r.fill))
        for rot in (0, 1, -1):
            p = r.read_block_cu8(1000, rotate=rot, timeout_ms=10)
            out.append(("r", rot, p.tobytes(), r.fill))
        g = r.generation
        r.purge()
        out.append(("purge", r.generation - g,
                    r.read_block_cu8(10, timeout_ms=10) is None, r.fill))
        # a full ring drops what does not fit, counted in bytes
        out.append(("w", r.write(data[8192:8192 + 20000]), r.fill, r.drops))
        p = r.read_block_cu8(8000, rotate=1, timeout_ms=10)
        out.append(("r", p.tobytes(), r.fill))
        out.append(("short", r.read_block_cu8(8000, timeout_ms=10) is None,
                    r.fill))
        out.append(("w", r.write(np.frombuffer(data[-3:], np.uint8)),
                    r.fill))
        log[name] = out
        r.close()
    assert log["port"] == log["jax"]
    assert log["port"][6][3] > 0              # the full ring dropped
    planes = np.frombuffer(log["port"][2][2], np.float32).reshape(-1, 2)
    raw = np.frombuffer(data[:2000], np.uint8).reshape(-1, 2)
    assert np.array_equal(planes, raw.astype(np.float32) * np.float32(
        1 / 127.5) - np.float32(1.0))


# -- StreamDecoder --------------------------------------------------------------
@pytest.mark.parametrize("mode", ["p25p1", "dmr"])
def test_stream_decoder_against_jax(mode):
    """4 s of the P25 call, or of the DMR stream, pushed in 0.25 s
    chunks into both packages' decoders, then flushed."""
    tv = SV.vector()
    x = SV.p25_iq(tv, 4 * 4800) if mode == "p25p1" else \
        SV.dmr_iq(tv, 4 * 4800)
    decs = {"jax": JS.StreamDecoder(mode),
            "port": PS.StreamDecoder(mode, device="cpu")}
    pushed = {k: [] for k in decs}
    for i in range(0, x.shape[0], CHUNK):
        for k, d in decs.items():
            pushed[k].append(len(d.push(x[i:i + CHUNK])))
    for k, d in decs.items():
        pushed[k].append(len(d.flush()))
    assert pushed["port"] == pushed["jax"]
    j, p = decs["jax"].ctx, decs["port"].ctx
    assert SV.events_equal(j.events, p.events) is None
    assert len(p.events) > 20
    assert decs["port"].last_snr_db == pytest.approx(
        decs["jax"].last_snr_db, abs=1e-4)
    assert sorted(p.audio) == sorted(j.audio)
    for slot in j.audio:
        a, b = SV.pcm(j, slot), SV.pcm(p, slot)
        assert a.shape == b.shape and a.size
        assert float(np.max(np.abs(a - b))) <= PCM_REL * float(
            np.max(np.abs(a)))


def test_stream_decoder_disc_input_against_jax():
    """The discriminator-tap input (``input_kind="disc"``), as the
    ``-i udp:`` / ``tcp:`` / ``.wav`` sources feed it."""
    tv = SV.vector()
    disc = _disc_pcm(SV.p25_iq(tv, 3 * 4800)).astype(np.float32) / 32768.0
    decs = {"jax": JS.StreamDecoder("p25p1", input_kind="disc"),
            "port": PS.StreamDecoder("p25p1", input_kind="disc",
                                     device="cpu")}
    for d in decs.values():
        for i in range(0, disc.shape[0], CHUNK):
            d.push(disc[i:i + CHUNK])
        d.flush()
    assert SV.events_equal(decs["jax"].ctx.events,
                           decs["port"].ctx.events) is None
    assert any("NAC/CC: 293" in e.line for e in decs["port"].ctx.events)


def test_measure_against_jax():
    """``dsp/measure``: the eye and constellation SNRs, the power
    squelch, the spectrum snapshot and the CFO observable on seeded
    inputs, the port's torch against the JAX functions (float32 sums in
    another order: within 1e-4 dB / 1e-5 relative); the bias terms
    exactly."""
    import jax.numpy as jnp
    import torch

    from dsdneo_tpu.dsp import measure as JM
    from dsdneo_tpu_torch.dsp import measure as PM
    rng = np.random.default_rng(5)
    lv = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
    norm = (lv[rng.integers(0, 4, (3, 4000))]
            + rng.normal(0, 0.2, (3, 4000))).astype(np.float32)
    iq = (rng.normal(size=(3, 8192)) + 1j * rng.normal(size=(3, 8192))
          ).astype(np.complex64) * np.float32(0.01)
    for j, p, arg in ((JM.snr_c4fm_eye, PM.snr_c4fm_eye, norm),
                      (JM.snr_qpsk_constellation, PM.snr_qpsk_constellation,
                       iq * 100),
                      (lambda x: JM.estimate_cfo_fm(x, 48000.0),
                       lambda x: PM.estimate_cfo_fm(x, 48000.0), norm)):
        a = np.asarray(j(jnp.asarray(arg)))
        b = p(torch.from_numpy(arg)).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    for thr in (-60.0, -37.0, -20.0):
        a = np.asarray(JM.power_squelch(jnp.asarray(iq), thr))
        b = PM.power_squelch(torch.from_numpy(iq), thr).numpy()
        assert np.array_equal(a, b)
    a = np.asarray(JM.spectrum_snapshot(jnp.asarray(iq), 1024))
    b = PM.spectrum_snapshot(torch.from_numpy(iq), 1024).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-3)
    for kind in ("c4fm", "evm", "other"):
        for rate in (0.0, 4800.0, 2400.0):
            for prof in ("wide", "6k25", "p25_cqpsk", "nope"):
                assert PM.snr_bias_db(kind, rate, prof) == \
                    JM.snr_bias_db(kind, rate, prof)
                assert PM.snr_corrected_db(20.0, kind, rate, prof) == \
                    JM.snr_corrected_db(20.0, kind, rate, prof)


# -- LiveEngine in lockstep ------------------------------------------------------
def _cu8_noise(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(120, 136, 2 * n, dtype=np.uint8).tobytes()


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_live_engine_udp_retune_journal_against_jax(tmp_path):
    """A UDP ``TUNE`` datagram retunes the engine (the control plane's
    thread), the retune lands in the capture journal at its byte offset,
    the ring is purged and the mute window drops the next block; the P25
    call decodes on both sides of it."""
    tv = SV.vector()
    call = LV.cu8(SV.p25_iq(tv, 4 * 4800))
    half = len(call) // 2 // (2 * CHUNK) * (2 * CHUNK)
    out = {}
    for name, L, IQ in (("jax", JL, JIQ), ("port", PL, PIQ)):
        d = tmp_path / name
        d.mkdir()
        port = _free_udp_port()
        events = []
        cap = IQ.IqCaptureWriter(str(d / "live.iq"), IQ.IqMetadata(
            sample_format="cf32", sample_rate_hz=48000))
        kw = {"device": "cpu"} if name == "port" else {}
        eng = L.LiveEngine("p25p1", block_s=0.25, capture_writer=cap,
                           control_port=port, on_event=events.append, **kw)
        eng.freq_hz = 851_000_000.0
        eng.feed_cu8(call[:half] + call[:2 * CHUNK])
        eng.run(max_blocks=half // (2 * CHUNK))
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(5.0)
        s.sendto(b"TUNE 851012500", ("127.0.0.1", port))
        assert s.recvfrom(64)[0] == b"OK\n"
        s.close()
        assert eng.retunes == 1 and eng.freq_hz == 851_012_500.0
        eng._stop = False
        eng.feed_cu8(call[half:])
        eng.run(max_blocks=(len(call) - half) // (2 * CHUNK))
        eng.stop()
        cap.close()
        with open(d / "live.iq.json") as f:
            side = json.load(f)
        with open(d / "live.iq", "rb") as f:
            body = f.read()
        out[name] = (events, side, body, eng.retunes,
                     eng.metrics.snapshot().blocks)
    (je, js, jb, jr, jn), (pe, ps, pb, pr, pn) = out["jax"], out["port"]
    assert SV.events_equal(je, pe) is None
    assert ps == js and pb == jb and (pr, pn) == (jr, jn)
    assert ps["capture_retune_count"] == 1
    assert ps["events"][0]["center_frequency_hz"] == 851_012_500
    assert ps["events"][0]["byte_offset"] == half // 2 * 8
    assert sum("LDU" in e.line for e in pe) >= 8


def test_retune_mute_window_and_tagged_completion_against_jax():
    """The case of ``tests/test_live_input.py`` in both packages: the
    mute window, stale-generation feeds, the first fresh feed completing
    the tune."""
    out = {}
    for name, L in (("jax", JL), ("port", PL)):
        kw = {"device": "cpu"} if name == "port" else {}
        eng = L.LiveEngine("p25p1", fs=48000.0, block_s=0.05,
                           retune_mute_s=0.075, **kw)
        blank = bytes(2 * 4800)
        trace = [eng.feed_cu8(blank)]
        g0 = eng.tune_generation
        eng.tune(851_000_000.0)
        trace += [eng.tune_generation - g0, eng.tune_pending,
                  eng.feed_cu8(blank, generation=g0), eng.stale_feeds,
                  eng.tune_pending,
                  eng.feed_cu8(blank, generation=eng.tune_generation),
                  eng.tune_pending]
        for _ in range(5):
            eng.feed_cu8(blank, generation=eng.tune_generation)
        trace.append(eng.run(max_blocks=2))
        trace.append(eng.metrics.snapshot().retune_muted)
        eng._stop = False
        trace.append(eng.run(max_blocks=2))
        trace.append(eng.metrics.snapshot().retune_muted)
        out[name] = trace
    assert out["port"] == out["jax"]
    assert out["port"][-4:] == [2, True, 2, False]


def test_squelch_hop_rotates_scanner_against_jax():
    out = {}
    for name, L, T in (("jax", JL, JT), ("port", PL, PT)):
        tunes = []
        now = [0.0]
        sc = T.TrunkScanner(tune=lambda f, m: tunes.append(f) or True,
                            dwell_s=0.0, hold_s=0.0, now_fn=lambda: now[0])
        sc.add_target(T.ScanTarget(851e6, "p25p1"))
        sc.add_target(T.ScanTarget(852e6, "p25p1"))
        kw = {"device": "cpu"} if name == "port" else {}
        eng = L.LiveEngine("p25p1", fs=48000.0, block_s=0.05, scanner=sc,
                           hop_s=0.1, retune_mute_s=0.0, **kw)
        eng.squelch_db = 10.0
        for _ in range(8):
            eng.feed_cu8(bytes(2 * 4800))
            now[0] += 0.05
        n = eng.run(max_blocks=8)
        out[name] = (n, tunes, sc.index)
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) >= 2


@pytest.mark.parametrize("knobs", [
    {"dc_block": True}, {"dc_block": True, "dc_shift": 3},
    {"fs4_shift": True}, {"fs4_shift": True, "combine_rot": False},
    {"input_volume": 0.5, "level_warn_db": -3.0, "snr_squelch_db": 40.0},
    {"retune_drain_s": 0.5, "output_clear_on_retune": True}],
    ids=["dc", "dc-shift", "fs4", "fs4-two-pass", "volume-snr-sql",
         "drain"])
def test_live_engine_knobs_against_jax(knobs):
    """The block loop's conditioning in both packages on 2 s of the P25
    call: the DC blocker, the fs/4 rotation fused into the ring read or
    in a second pass, the input volume with the level warning and the
    SNR squelch, the retune drain budget with the output clear."""
    tv = SV.vector()
    x = SV.p25_iq(tv, 2 * 4800)
    if knobs.get("fs4_shift"):
        # the tuner sits fs/4 above the channel: j^{-n} on the air
        x = (x * np.power(-1j, np.arange(x.shape[0]) % 4)).astype(
            np.complex64)
    call = LV.cu8(x)
    out = {}
    for name, L in (("jax", JL), ("port", PL)):
        kw = {"device": "cpu"} if name == "port" else {}
        events = []
        eng = L.LiveEngine("p25p1", block_s=0.25, on_event=events.append,
                           **kw)
        for k, v in knobs.items():
            setattr(eng, k, v)
        eng.feed_cu8(call)
        n = eng.run(max_blocks=4)
        if "retune_drain_s" in knobs:
            eng.tune(851_012_500.0)
            eng._stop = False
        n2 = eng.run(max_blocks=len(call) // (2 * CHUNK))
        out[name] = (events, n, n2, eng.level_warnings, eng.retunes,
                     {k: sum(map(len, v))
                      for k, v in eng.decoder.ctx.audio.items()})
    assert SV.events_equal(out["jax"][0], out["port"][0]) is None
    assert out["port"][1:] == out["jax"][1:]
    if "snr_squelch_db" not in knobs:
        assert any("LDU" in e.line for e in out["port"][0])


def test_live_engine_perf_probe_against_jax(tmp_path):
    """``--perf-csv`` on the live path: one CSV row a block (interval 0),
    the block, channel, symbol and ring-drop columns equal (the times
    are the host's own); the port's ring reads fill ``ingest_ms``."""
    from dsdneo_tpu.runtime import log as JLOG
    from dsdneo_tpu_torch.runtime import log as PLOG
    call = LV.cu8(SV.p25_iq(SV.vector(), 2 * 4800))
    rows, ingest = {}, {}
    for name, L, LOG in (("jax", JL, JLOG), ("port", PL, PLOG)):
        path = str(tmp_path / f"{name}.csv")
        probe = LOG.PerfProbe(path, interval_s=0.0)
        kw = {"device": "cpu"} if name == "port" else {}
        eng = L.LiveEngine("p25p1", block_s=0.25, perf=probe, **kw)
        eng.feed_cu8(call)
        eng.run(max_blocks=len(call) // (2 * CHUNK))
        probe.close()
        with open(path) as f:
            lines = [ln.split(",") for ln in f.read().splitlines()]
        head = lines[0]
        keep = [head.index(k) for k in ("steps", "channels", "symbols",
                                        "drops")]
        rows[name] = (head, [[r[i] for i in keep] for r in lines[1:]])
        ingest[name] = [float(r[head.index("ingest_ms")]) for r in lines[1:]]
    assert rows["port"] == rows["jax"]
    assert len(rows["port"][1]) == 8
    assert all(v > 0 for v in ingest["port"]), ingest["port"]


def test_live_engine_commands_against_jax():
    """The app_control command queue drained between blocks (the cases
    of ``tests/test_app_control.py`` in both packages): TUNE before
    feeding, the metrics of four blocks, SET_MODE, TOGGLE_MUTE,
    SET_SQUELCH, GAIN_DELTA, TG_HOLD and TG_RELEASE on the policy,
    SET_PPM into the tuner hook, STOP halting the loop at once."""
    from dsdneo_tpu.app_control import AppCommand as JC
    from dsdneo_tpu.core.talkgroup import TalkgroupPolicy as JP
    from dsdneo_tpu_torch.app_control import AppCommand as PC
    from dsdneo_tpu_torch.core.talkgroup import TalkgroupPolicy as PP
    raw = np.random.default_rng(0).integers(0, 256, 2 * 4800 * 3,
                                             dtype=np.uint8).tobytes()
    out = {}
    for name, L, C, TP in (("jax", JL, JC, JP), ("port", PL, PC, PP)):
        kw = {"device": "cpu"} if name == "port" else {}
        eng = L.LiveEngine("p25p1", fs=48000.0, block_s=0.05, **kw)
        eng.commands.put(C.TUNE, 852_000_000.0)
        eng._drain_commands()
        eng.feed_cu8(raw)
        n = eng.run(max_blocks=4)
        snap = eng.metrics.snapshot()
        trace = [n, snap.generation, snap.freq_hz, eng.retunes,
                 round(snap.input_level_rms, 9)]
        eng.decoder.ctx.state.tg_policy = TP()
        ppm = []
        eng.on_ppm = ppm.append
        for cmd, payload in ((C.SET_MODE, "dmr"), (C.TOGGLE_MUTE, None),
                             (C.SET_SQUELCH, -50.0), (C.GAIN_DELTA, 1),
                             (C.TG_HOLD, (0, 123)), (C.SET_PPM, 7)):
            eng.commands.put(cmd, payload)
        eng._drain_commands()
        pol = eng.decoder.ctx.state.tg_policy
        trace += [eng.mode, eng.decoder.mode.name, eng.muted,
                  eng.squelch_db, eng.gain_db,
                  eng.decoder.ctx.state.audio_gain_db, ppm,
                  pol.allows(999, slot=0), pol.allows(123, slot=0)]
        eng.commands.put(C.TG_RELEASE, 0)
        eng.commands.put(C.STOP)
        trace += [eng.run(), pol.allows(999, slot=0), eng._stop]
        out[name] = trace
    assert out["port"] == out["jax"]
    assert out["port"][:4] == [4, out["port"][1], 852_000_000.0, 1]
    assert out["port"][-3:] == [0, True, True]


def test_live_engine_trunk_integration_against_jax():
    """The live-engine case of ``tests/test_trunk_follower.py``: a block
    of noise through the engine with a follower attached; no sync, so
    the follower stays IDLE, and the tick ran."""
    out = {}
    for name, L, T in (("jax", JL, JT), ("port", PL, PT)):
        kw = {"device": "cpu"} if name == "port" else {}
        eng = L.LiveEngine("p25p1", block_s=0.25, **kw)
        sm = T.TrunkSM(lambda f, k: True, now_fn=lambda: 0.0)
        fo = T.TrunkFollower(sm, eng.decoder.ctx,
                             current_freq=lambda: eng.freq_hz)
        eng.freq_hz = 853_000_000.0
        eng.trunk = fo
        eng.feed_cu8(_cu8_noise(12000, 0))
        out[name] = (eng.run(max_blocks=1), sm.phase.name,
                     len(eng.decoder.ctx.events))
    assert out["port"] == out["jax"] == (1, "IDLE", 0)


# -- the closed loop --------------------------------------------------------------
def test_closed_loop_one_tuner_against_jax():
    """CC → the granted call → CC after the hangtime, in both packages:
    the same tunes and events, and every LDU of the call exact."""
    tv = FV.vector()
    loops = {}
    for name, L, T, kw in (("jax", JL, JT, {}),
                           ("port", PL, PT, {"device": "cpu"})):
        loop = LV.ClosedLoop(L.LiveEngine, T.TrunkSM, T.TrunkFollower,
                             SV.ImbeSink(), engine_kw=kw)
        loop.run(tv)
        loops[name] = loop
    j, p = loops["jax"], loops["port"]
    assert p.tunes == j.tunes
    assert p.events == j.events
    assert p.sm.events == j.sm.events == [
        "ON_CC 850.9040 MHz", "TUNED TG 101 @ 851.1500 MHz",
        "→ CC (hangtime expired)"]
    got = LV.judge(p, tv)
    assert LV.judge(j, tv) == got
    assert got["frames"] == 99 and got["ldus"] == 11


# -- sockets ---------------------------------------------------------------------
def test_rtl_tcp_into_the_ring_and_live_engine():
    """The port's ``RtlTcpClient`` against its ``FakeRtlTcpServer``
    (the P25 call as CU8), through the ring into ``LiveEngine.start`` /
    ``stop``: the decoded events are the call's; a retune reaches the
    server as a SET_FREQ command."""
    tv = SV.vector()
    srv = PR.FakeRtlTcpServer(LV.cu8(SV.p25_iq(tv, 4 * 4800)))
    events = []
    eng = PL.LiveEngine("p25p1", block_s=0.25, on_event=events.append,
                        device="cpu")
    cli = PR.RtlTcpClient("127.0.0.1", srv.port, eng.ring,
                          sample_rate=48000, freq_hz=851_000_000, ppm=3)
    try:
        assert cli.tuner_type == 5
        cli.start()
        eng.start()
        deadline = time.time() + 60
        while time.time() < deadline and sum(
                "LDU2 VOICE" in e.line for e in events) < 8:
            time.sleep(0.1)
        cli.set_freq(851_012_500)
    finally:
        eng.stop()
        cli.close()
        srv.close()
    ldus = [e for e in events if "VOICE (9 IMBE frames)" in e.line]
    assert len(ldus) >= 16
    assert any("Group 2501 Source 1234567" in e.line for e in events)
    assert (PR.CMD_SET_FREQ, 851_012_500) in srv.commands
    assert (PR.CMD_SET_SAMPLE_RATE, 48000) in srv.commands


_PACE_PROBE = r"""
import resource, socket, sys, time
from dsdneo_tpu_torch.io import rtl_tcp as PR
def cpu():
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime
payload = bytes(96_000)
srv = PR.FakeRtlTcpServer(payload, chunk=8192, pace_bytes_per_s=96_000)
c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
c.settimeout(5)
got = len(c.recv(12))
t, t0 = cpu(), time.monotonic()
while got < 12 + len(payload):
    got += len(c.recv(65536))
print(time.monotonic() - t0, cpu() - t)
c.close()
srv.close()
"""


def test_fake_server_waits_for_its_pace():
    """A 1 s paced serve (96 kB at 96 kB/s), in a fresh process, costs
    that process well under 0.3 s of CPU time: the server waits for its
    budget to allow the next chunk instead of polling it."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PACE_PROBE], cwd=root,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    wall, cpu = map(float, out.stdout.split())
    assert 0.8 <= wall <= 3.0
    assert cpu < 0.3


def _disc_pcm(x: np.ndarray) -> np.ndarray:
    """A radio's discriminator tap of complex baseband: the port's P25
    channel filter and FM discriminator (CPU), as PCM16."""
    import torch

    from dsdneo_tpu_torch.dsp import firdes, frontend
    taps = torch.from_numpy(firdes.channel_lpf(48000.0, "p25_c4fm"))
    y = frontend.fir_complex(torch.from_numpy(x[None, :]), taps)
    d = frontend.fm_discriminate(y)[0].numpy()
    return np.clip(d * 8000.0, -32767, 32767).astype(np.int16)
