"""The port's CLI extras against the JAX package's, on the CPU: the
wizard (``runtime/wizard.py``), auto-PPM (``io/auto_ppm.py``), the tuner
autogain (``io/auto_gain.py``) and their hooks in ``engine/live.py``,
the Rdio uploader (``io/rdio.py``) behind ``core/calls.CallRecorder``,
and ``--fleet --frontend http``.

Equal means: the wizard's results and printed lines on the same scripted
answers; the same ``set_ppm`` / ``set_gain`` calls, in order, from the
same seeded inputs (clocks given by the test), and, through
``LiveEngine`` in lockstep (as in ``test_torch_live.py``), from the same
CU8 payloads, with the engines' events equal; the same multipart parts
posted to a local server (the boundary is random in both; the Rdio
sidecar's ``start_time``/``stop_time`` are wall-clock seconds and are
the fields left out); and the fleet console's ``/grid``, ``/events``,
``/calls`` and ``/snapshot`` bytes, read as each CLI stops its server.
"""

import http.server
import itertools
import json
import threading
import urllib.request
from email.parser import BytesParser
from email.policy import HTTP

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.app_control import http as JH  # noqa: E402
from dsdneo_tpu.engine import live as JL  # noqa: E402
from dsdneo_tpu.io import auto_gain as JG  # noqa: E402
from dsdneo_tpu.io import auto_ppm as JA  # noqa: E402
from dsdneo_tpu.io import rdio as JR  # noqa: E402
from dsdneo_tpu.runtime import wizard as JW  # noqa: E402
from dsdneo_tpu_torch.app_control import http as PH  # noqa: E402
from dsdneo_tpu_torch.engine import fleetvec as FV  # noqa: E402
from dsdneo_tpu_torch.engine import live as PL  # noqa: E402
from dsdneo_tpu_torch.engine import livevec as LV  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.io import auto_gain as PG  # noqa: E402
from dsdneo_tpu_torch.io import auto_ppm as PA  # noqa: E402
from dsdneo_tpu_torch.io import rdio as PR  # noqa: E402
from dsdneo_tpu_torch.io.iq import IqMetadata, write_iq_capture  # noqa: E402
from dsdneo_tpu_torch.runtime import wizard as PW  # noqa: E402

from test_torch_cli import both  # noqa: E402  (tests/)


# -- the wizard -----------------------------------------------------------
SCRIPTS = [
    {},                                                  # every default
    {"mode": "2", "I/Q": "call.iq", "audio": "wav:out.wav",
     "streamed": "0.25"},
    {"mode": "m17", "I/Q": "  x.iq.json ", "audio": "", "streamed": "-1"},
    {"mode": "99", "audio": "udp:127.0.0.1:7355", "streamed": "fast"},
    {"mode": "11", "streamed": " 2 "},
]


@pytest.mark.parametrize("script", range(len(SCRIPTS)))
def test_run_wizard_equal_on_scripted_answers(script):
    answers = SCRIPTS[script]
    out = {}
    for name, W in (("jax", JW), ("port", PW)):
        asked, said = [], []

        def ask(prompt, default):
            asked.append((prompt, default))
            for key, v in answers.items():
                if prompt.startswith(key):
                    return v
            return default
        r = W.run_wizard(ask, say=said.append)
        out[name] = ((r.mode, r.iq_replay, r.audio_out, r.stream_s),
                     asked, said)
    assert out["port"] == out["jax"]
    assert [k for _, k, _ in PW.MODE_CHOICES] == \
        [k for _, k, _ in JW.MODE_CHOICES]


# -- auto-PPM and the tuner autogain -------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_ppm_same_corrections(seed):
    rng = np.random.default_rng(seed)
    kw = [{}, {"zerolock_hz": 45.0, "pwr_gate_db": -60.0},
          {"deadband_ppm": 0.8, "max_step_ppm": 3, "train_blocks": 3,
           "ema": 0.5}][seed]
    calls = {"jax": [], "port": []}
    loops = {"jax": JA.AutoPpm(calls["jax"].append, 851e6, **kw),
             "port": PA.AutoPpm(calls["port"].append, 851e6, **kw)}
    drift = rng.choice([-1.0, 1.0]) * rng.uniform(1000, 3000)
    prev = 0
    for _ in range(400):
        cfo = drift + rng.normal(0, 80)
        snr, pwr = rng.uniform(0, 25), rng.uniform(-90, -20)
        got = {n: L.update(cfo, snr, pwr_db=pwr) for n, L in loops.items()}
        assert got["port"] == got["jax"]
        if got["port"]:
            # a step of the correction moves the observed offset by
            # step · f · 1e-6
            drift += (calls["port"][-1] - prev) * 851.0
            prev = calls["port"][-1]
    assert calls["port"] == calls["jax"] and calls["port"]
    for a in ("ppm", "locked", "corrections"):
        assert getattr(loops["port"], a) == getattr(loops["jax"], a)


@pytest.mark.parametrize("n", [17, 4000])
def test_estimate_cfo_hz(n):
    rng = np.random.default_rng(n)
    x = (np.exp(2j * np.pi * 733.0 * np.arange(n) / 48000.0)
         + 0.05 * rng.standard_normal(n)).astype(np.complex64)
    assert PA.estimate_cfo_hz(x, 48000.0) == JA.estimate_cfo_hz(x, 48000.0)
    assert PA.estimate_cfo_hz(x[:15], 48000.0) == 0.0
    if n > 1000:
        assert abs(PA.estimate_cfo_hz(x, 48000.0) - 733.0) < 20.0


def _clock(step: float):
    c = itertools.count(0)
    return lambda: next(c) * step


@pytest.mark.parametrize("case", ["clip", "quiet", "empty", "retune"])
def test_tuner_autogain_same_gain_steps(case):
    rng = np.random.default_rng(len(case))
    calls = {"jax": [], "port": []}
    ags = {n: G.TunerAutogain(calls[n].append, window_blocks=8,
                              now_fn=_clock(0.25))
           for n, G in (("jax", JG), ("port", PG))}
    t = np.arange(2048)
    for blk in range(160):
        if case == "clip":
            x = 1.2 * np.exp(1j * (0.3 * t + blk))
        elif case in ("quiet", "retune"):
            x = 0.02 * np.exp(2j * np.pi * 0.05 * t) \
                + 0.002 * rng.standard_normal(2048)
        else:
            x = 0.01 * (rng.standard_normal(2048)
                        + 1j * rng.standard_normal(2048))
        x = x.astype(np.complex64)
        if case == "retune" and blk % 50 == 25:
            for a in ags.values():
                a.on_retune()
        for a in ags.values():
            a.update(x, squelch_open=(blk % 7 != 3))
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == 300              # the seed, 30 dB
    if case == "clip":
        assert calls["port"][1] == 250          # clipping: down 5 dB
    if case == "quiet":
        assert calls["port"][1] > 300           # quiet and clean: up
    if case == "empty":
        assert calls["port"] == [300]           # the gate holds


def _live_lockstep(payload: bytes, block_s: float, hooks) -> dict:
    out = {}
    for name, L, A, G in (("jax", JL, JA, JG), ("port", PL, PA, PG)):
        kw = {"device": "cpu"} if name == "port" else {}
        events, ppm, gain = [], [], []
        eng = L.LiveEngine("p25p1", block_s=block_s,
                           on_event=events.append, **kw)
        if "ppm" in hooks:
            eng.auto_ppm = A.AutoPpm(ppm.append, 851e6, snr_gate_db=6.0)
        if "gain" in hooks:
            eng.auto_gain = G.TunerAutogain(gain.append, window_blocks=4,
                                            now_fn=_clock(1.0))
        eng.feed_cu8(payload)
        n = eng.run(max_blocks=len(payload) // int(2 * 48000 * block_s))
        if "retune" in hooks:
            eng.tune(851_012_500.0)
            eng._stop = False
            eng.feed_cu8(payload)
            n += eng.run(max_blocks=len(payload)
                         // int(2 * 48000 * block_s))
        out[name] = (events, n, ppm, gain)
    return out


@pytest.mark.parametrize("cfo", [1500.0, -2200.0])
def test_live_engine_auto_ppm_against_jax(cfo):
    """The P25 call with a carrier offset: both engines train the loop
    past the mute window on the same blocks and ask the same
    corrections; a positive offset asks a negative step (the librtlsdr
    convention, ``io/auto_ppm.py``)."""
    x = SV.p25_iq(SV.vector(), 3 * 4800)
    x = (x * np.exp(2j * np.pi * cfo * np.arange(x.shape[0]) / 48000.0)
         ).astype(np.complex64)
    out = _live_lockstep(LV.cu8(x), 0.25, ("ppm",))
    assert SV.events_equal(out["jax"][0], out["port"][0]) is None
    assert out["port"][1:] == out["jax"][1:]
    ppm = out["port"][2]
    assert ppm and np.sign(ppm[0]) == -np.sign(cfo)
    assert abs(ppm[0]) == 2                  # max_step_ppm
    assert any("LDU" in e.line for e in out["port"][0])


@pytest.mark.parametrize("scale", [4.0, 0.05])
def test_live_engine_autogain_against_jax(scale):
    """A clipped and a quiet payload through both engines, a retune
    between two passes (``on_retune``'s hold): the same ``set_gain``
    calls; the clipped one steps down."""
    x = SV.p25_iq(SV.vector(), 2 * 4800) * scale
    out = _live_lockstep(LV.cu8(x.astype(np.complex64)), 0.25,
                         ("gain", "retune"))
    assert SV.events_equal(out["jax"][0], out["port"][0]) is None
    assert out["port"][1:] == out["jax"][1:]
    gain = out["port"][3]
    assert gain[0] == 300
    if scale > 1:
        assert gain[1] == 250


# -- Rdio ---------------------------------------------------------------------
class _Sink:
    """A local HTTP server keeping each POST's multipart parts."""

    def __init__(self):
        self.received = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                msg = BytesParser(policy=HTTP).parsebytes(
                    f"Content-Type: {ctype}\r\n\r\n".encode() + body)
                parts = {p.get_param("name", header="content-disposition"):
                         (p.get_filename(), p.get_content_type(),
                          p.get_payload(decode=True))
                         for p in msg.iter_parts()}
                outer.received.append(parts)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                   Handler)
        self.port = self.srv.server_address[1]
        self.t = threading.Thread(target=self.srv.serve_forever,
                                  daemon=True)
        self.t.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_build_multipart_same_bytes(monkeypatch):
    import uuid
    fixed = uuid.UUID(int=0x1234)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    fields = {"key": "sekrit", "system": b"sys1"}
    files = {"audio": ("a.wav", b"RIFF" + bytes(40), "audio/wav"),
             "meta": ("a.json", b'{"x": 1}', "application/json")}
    assert PR.build_multipart(fields, files) == \
        JR.build_multipart(fields, files)


def test_recorder_uploads_through_rdio(tmp_path):
    """``CallRecorder`` with an uploader in each package: the decode of
    the P25 call exports its calls, each posted with the same key,
    system, audio bytes and Rdio meta (but its wall-clock times)."""
    from dsdneo_tpu.core.calls import CallRecorder as JCR
    from dsdneo_tpu.engine.decoder import decode_samples as jdec
    from dsdneo_tpu_torch.core.calls import CallRecorder as PCR
    from dsdneo_tpu_torch.engine.decoder import decode_samples as pdec
    x = SV.p25_iq(SV.vector(), 3 * 4800)
    posted = {}
    for name, CR, dec, R, kw in (
            ("jax", JCR, jdec, JR, {}),
            ("port", PCR, pdec, PR, {"device": "cpu"})):
        sink = _Sink()
        d = str(tmp_path / name)
        rec = CR(d, mode="p25p1")
        rec.uploader = R.RdioUploader(
            f"http://127.0.0.1:{sink.port}/api/call-upload", "sekrit", "7")
        dec(x, "p25p1", call_recorder=rec, **kw)
        rec.finish_all()
        rec.uploader.close()
        sink.close()
        assert rec.uploader.uploaded == len(rec.finished) >= 1
        assert rec.uploader.failed == rec.uploader.dropped == 0
        posted[name] = sink.received
    assert len(posted["port"]) == len(posted["jax"])
    for pj, pp in zip(posted["jax"], posted["port"]):
        assert set(pp) == set(pj) == {"key", "system", "audio", "meta"}
        for k in ("key", "system"):
            assert pp[k] == pj[k]
        assert pp["audio"][:2] == pj["audio"][:2]     # name, type
        a = np.frombuffer(pj["audio"][2][44:], "<i2").astype(float)
        b = np.frombuffer(pp["audio"][2][44:], "<i2").astype(float)
        assert a.shape == b.shape and np.abs(a - b).max() <= \
            2e-3 * max(np.abs(a).max(), 1.0)
        mj, mp = (json.loads(p["meta"][2]) for p in (pj, pp))
        for m in (mj, mp):
            assert m.pop("stop_time") - m.pop("start_time") >= 0
        assert mp == mj and mp["talkgroup"] > 0


def test_write_rdio_meta_same_json(tmp_path):
    for src, freq in ((42, 851_000_000), (0, 5)):
        for n, R in (("jax", JR), ("port", PR)):
            R.write_rdio_meta(str(tmp_path / f"{n}.json"), start_time=100.7,
                              stop_time=105.2, talkgroup=123, source=src,
                              freq_hz=freq, system="sys1",
                              talkgroup_tag="Fire")
        assert (tmp_path / "port.json").read_bytes() == \
            (tmp_path / "jax.json").read_bytes()


def test_uploader_failures_and_queue_bound(tmp_path):
    up = PR.RdioUploader("http://127.0.0.1:1/api", api_key="k", system="s",
                         retries=1, timeout_s=0.5, max_queue=2)
    wav = tmp_path / "c.wav"
    wav.write_bytes(b"RIFF")
    sub = [up.submit(str(wav), str(wav)) for _ in range(6)]
    up.close(timeout=20)
    assert up.failed + up.dropped == 6 and up.uploaded == 0
    assert sub.count(True) == up.failed


# -- --fleet --frontend http ----------------------------------------------
@pytest.fixture(scope="module")
def fleet_cap(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    tv = FV.vector()
    x = np.concatenate([FV.c4fm48(tv["bench_cc_dibits"][:4800], 1),
                        SV.p25_iq(SV.vector(), 2 * 4800)])
    write_iq_capture(str(d / "fleet.iq"), x, IqMetadata(
        sample_format="cf32", sample_rate_hz=48000))
    return str(d / "fleet.iq")


def test_fleet_http_console_against_jax(fleet_cap, tmp_path, monkeypatch):
    """Both CLIs serve the fleet console for one block; each server's
    four data endpoints are read as its CLI stops it: equal bytes, two
    channels on the grid, the control channel's NAC line among the
    events and its grant in ``/calls``."""
    seen = {}
    for name, H in (("jax", JH), ("port", PH)):
        real = H.HttpFrontend.stop

        def stop(self, _real=real, _name=name):
            seen[_name] = {p: urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{p}", timeout=10).read()
                for p in ("/grid", "/events?n=500", "/calls", "/snapshot")}
            _real(self)
        monkeypatch.setattr(H.HttpFrontend, "stop", stop)
    jr, pr = both(tmp_path, ["--iq-replay", fleet_cap, "--fleet",
                             "p25p1:cc:2", "--frontend", "http",
                             "--http-port", "0", "--duration", "0.1"])
    assert pr[0] == jr[0] == 0
    norm = [ln for ln in pr[2].splitlines() if "http frontend" not in ln]
    assert norm == [ln for ln in jr[2].splitlines()
                    if "http frontend" not in ln]
    assert "fleet: 1 blocks over 2 channels" in pr[2]
    assert seen["port"] == seen["jax"]
    grid = json.loads(seen["port"]["/grid"])["channels"]
    assert len(grid) == 2 and {c["state"] for c in grid} == {"cc"}
    evs = json.loads(seen["port"]["/events?n=500"])["events"]
    assert any("NAC/CC" in e for e in evs)
    calls = json.loads(seen["port"]["/calls"])["calls"]
    assert any(c["tg"] == 101 for c in calls)
    snap = json.loads(seen["port"]["/snapshot"])
    assert snap["blocks"] == 1 and snap["stream_active"] is True


def test_interactive_setup_alias(fleet_cap, tmp_path, monkeypatch):
    """``--interactive-setup`` runs the wizard (answers at their
    defaults: stdin at its end), then decodes the named capture."""
    import builtins

    def no_input(prompt=""):
        raise EOFError
    monkeypatch.setattr(builtins, "input", no_input)
    jr, pr = both(tmp_path, ["--interactive-setup", "--iq-replay",
                             fleet_cap])
    assert pr == jr[:3] + (pr[3],) and pr[0] == 0
    assert "dsd-neo-tpu setup wizard" in pr[2]
    monkeypatch.setenv("DSD_NEO_NO_BOOTSTRAP", "1")
    jr, pr = both(tmp_path / "nb", ["--wizard", "--iq-replay", fleet_cap])
    assert pr[:3] == jr[:3] and "setup wizard" not in pr[2]
