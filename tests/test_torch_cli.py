"""The port's CLI (``python -m dsdneo_tpu_torch``) against the JAX
package's (``dsdneo_tpu.cli``), both run in process with ``--platform
cpu`` on the same captures, written by the port's ``io.iq`` from the
vectors of ``data/serial_tables.npz`` (``engine/serialvec``): 4 s of the
P25 call and 4 s of the DMR stream's Basic Privacy window at 48 kHz.

Equal means: the printed lines (stdout and stderr, each package's own
output directory replaced by one name), the event log (``-J``), the
frame log, the ``.imb`` file byte for byte, the call records
(``--calls-dir``: every field; the sidecar holds no wall-clock time, the
Rdio sidecar, which does, is held in ``test_torch_cli_extras.py``) and
every WAV within 2e-3 of its peak.  Every flag the port's CLI refused
while its branch was not ported (the HTTP and terminal frontends, the
wizard, Rdio upload, auto-PPM, the tuner autogain, M17 transmit) runs
its branch here.
"""

import contextlib
import io
import json
import os
import wave

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

import torch  # noqa: E402

from dsdneo_tpu import cli as J  # noqa: E402
from dsdneo_tpu_torch import cli as P  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.io.iq import IqMetadata, write_iq_capture  # noqa: E402

PCM_REL = 2e-3
N_SYM = 4 * 4800                      # 4 s at 4800 symbols/s


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("caps")
    tv = SV.vector()
    meta = IqMetadata(sample_format="cf32", sample_rate_hz=48000)
    out = {"dir": str(d), "bp_key_id": int(tv["dmr_ids"][4])}
    write_iq_capture(str(d / "p25.iq"), SV.p25_iq(tv, N_SYM), meta)
    out["p25"] = str(d / "p25.iq")
    x = SV.dmr_iq(tv, N_SYM, start=int(tv["dmr_windows"][1]))
    write_iq_capture(str(d / "dmr.iq"), x,
                     IqMetadata(sample_format="cs16", sample_rate_hz=48000))
    out["dmr"] = str(d / "dmr.iq")
    with open(d / "freqs.csv", "w") as f:
        f.write("freq\n851.0125\n851.0375\n851.0625\n851.1125\n")
    out["freqs"] = str(d / "freqs.csv")
    kid, key = int(tv["p25_ids"][4]), int(tv["p25_ids"][3])
    with open(d / "keys.csv", "w") as f:            # the ADP key, decimal
        f.write(f"id,key\n{kid},{key}\n")
    out["keys"] = str(d / "keys.csv")
    with open(d / "keys_hex.csv", "w") as f:
        f.write("id,key\n1A,0123456789\n")
    with open(d / "keys_aes.csv", "w") as f:
        f.write("kid,s1,s2\n0B,0123456789ABCDEF,FEDCBA9876543210\n")
    with open(d / "groups.csv", "w") as f:
        f.write("tg,mode,name\n2501,A,Ops\n300-310,B,Blocked\n")
    with open(d / "chans.csv", "w") as f:
        f.write("channel,frequency\n1,851012500\n2,851037500\n")
    with open(d / "user.ini", "w") as f:
        f.write("[dsdneo]\ndeemph = 75\naudio_lpf_hz = 3000\n"
                "[profile:quiet]\nsnr_sql_db = 12.5\n")
    out["ini"] = str(d / "user.ini")
    return out


def run(main, argv, cwd):
    """``main(argv)`` in ``cwd``: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(list(argv))
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


def both(tmp_path, argv):
    """Run both CLIs on ``argv`` (``{out}`` in an argument names each
    package's own output directory); returns their results and
    directories, the printed text with the directory replaced."""
    res = {}
    for name, main in (("jax", J.main), ("port", P.main)):
        d = str(tmp_path / name)
        os.makedirs(d, exist_ok=True)
        args = ["--platform", "cpu"] + [a.replace("{out}", d) for a in argv]
        rc, so, se = run(main, args, d)
        res[name] = (rc, so.replace(d, "{out}"), se.replace(d, "{out}"), d)
    return res["jax"], res["port"]


def wav_frames(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
        ch = w.getnchannels()
        assert w.getsampwidth() == 2 and w.getframerate() == 8000
    return np.frombuffer(raw, "<i2").astype(np.float32).reshape(-1, ch) \
        / 32768.0


def assert_wav_close(a: str, b: str) -> None:
    x, y = wav_frames(a), wav_frames(b)
    assert x.shape == y.shape and x.size
    peak = float(np.max(np.abs(x))) or 1.0
    assert float(np.max(np.abs(x - y))) <= PCM_REL * peak


def assert_same_text(jr, pr) -> None:
    assert pr[0] == jr[0]
    assert pr[1] == jr[1]
    assert pr[2] == jr[2]


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_p25_replay_logs_calls_and_mbe_round_trip(caps, tmp_path):
    """-f1 over 4 s of the P25 call with every file output; then
    ``--mbe-in`` of the ``.imb`` it wrote."""
    jr, pr = both(tmp_path, [
        "-f1", "--iq-replay", caps["p25"], "-o", "wav:{out}/out.wav",
        "-J", "{out}/events.log", "--frame-log", "{out}/frames.log",
        "--calls-dir", "{out}/calls", "--mbe-out", "{out}/voice.imb",
        "-L", "{out}/lrrp.log", "-c", "{out}/sym.bin",
        "--keys-dec", caps["keys"], "--perf-csv", "{out}/perf.csv"])
    assert_same_text(jr, pr)
    assert jr[0] == 0 and "MBE out: 189 frames" in jr[2]
    assert "key 0042: [redacted]" in jr[2]
    jd, pd = jr[3], pr[3]
    # every IMBE frame of the .imb is the vector's clear voice (the ADP
    # superframes decrypted with the key)
    from dsdneo_tpu_torch.io.mbe_files import read_mbe_file
    kind, frames = read_mbe_file(os.path.join(pd, "voice.imb"))
    clear = np.unpackbits(SV.vector()["p25_clear88"], axis=-1)[..., :88]
    assert kind == "imb" and len(frames) == 189
    assert not any(e for e, _ in frames)
    assert np.array_equal(np.stack([b for _, b in frames]),
                          clear.reshape(-1, 88)[:189])
    for f in ("events.log", "frames.log", "voice.imb", "sym.bin",
              "lrrp.log"):
        assert read(os.path.join(pd, f)) == read(os.path.join(jd, f)), f
    assert read(os.path.join(jd, "events.log"))
    # the perf CSV holds wall-clock times: the same header and row count
    perf = [read(os.path.join(d, "perf.csv")).decode().splitlines()
            for d in (jd, pd)]
    assert perf[0][0] == perf[1][0] and len(perf[0]) == len(perf[1]) == 2
    assert_wav_close(os.path.join(jd, "out.wav"), os.path.join(pd, "out.wav"))
    names = sorted(os.listdir(os.path.join(jd, "calls")))
    assert names == sorted(os.listdir(os.path.join(pd, "calls")))
    assert names == ["TG2501_0001.json", "TG2501_0001.wav"]
    for n in names:
        a, b = os.path.join(jd, "calls", n), os.path.join(pd, "calls", n)
        if n.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fb) == json.load(fa)
        else:
            assert_wav_close(a, b)
    # the .imb back to PCM, in each package from its own file
    for name, main in (("jax", J.main), ("port", P.main)):
        d = jd if name == "jax" else pd
        rc, so, se = run(main, ["--platform", "cpu", "--mbe-in",
                                os.path.join(d, "voice.imb"), "-o",
                                "wav:" + os.path.join(d, "mbe.wav")], d)
        assert rc == 0 and se == "MBE file: imb 189 frames -> 3.78 s\n"
    assert_wav_close(os.path.join(jd, "mbe.wav"), os.path.join(pd, "mbe.wav"))


def test_dmr_basic_privacy_stereo(caps, tmp_path):
    """-fs with the Basic Privacy key ID (``-b``) into the two-slot
    stereo WAV (``wav2:``)."""
    jr, pr = both(tmp_path, ["-fs", "-b", str(caps["bp_key_id"]),
                             "--iq-replay", caps["dmr"],
                             "-o", "wav2:{out}/out.wav"])
    assert_same_text(jr, pr)
    assert jr[0] == 0 and "DMR" in jr[2]
    assert_wav_close(os.path.join(jr[3], "out.wav"),
                     os.path.join(pr[3], "out.wav"))


def test_keys_policies_and_maps(caps, tmp_path):
    """The key CSVs (decimal, hex, AES) and the forced key, every vendor
    key flag, the group list as a whitelist with a talkgroup hold, the
    channel map, and the short-flag state knobs (-x, -V, -D, -_, -m):
    the same lines (the key summary with --show-keys; the P25 case holds
    it redacted) and the same decode."""
    h = "0123456789ABCDEF0123456789ABCDEF"
    jr, pr = both(tmp_path, [
        "-fs", "--iq-replay", caps["dmr"], "-b", str(caps["bp_key_id"]),
        "--keys-dec", caps["keys"], "-K", caps["dir"] + "/keys_hex.csv",
        "--keys-aes", caps["dir"] + "/keys_aes.csv", "-1", "ABCDEF",
        "--key-csi72", "0102030405060708AB",
        "--key-tyt16", "ABCD", "--key-tyt-ep", h, "--key-retevis", h,
        "--key-tyt-ap", h, "--key-baofeng", h, "-H", "0123456789",
        "-9", "1234", "-A", "BEEF", "-S", "DEADBEEF:32",
        "-G", caps["dir"] + "/groups.csv", "-W", "-I", "2501",
        "-C", caps["dir"] + "/chans.csv", "-xr", "-V", "1", "-D", "3",
        "-_", "7", "-mc", "-0", "-3", "-q", "-Z", "--show-keys"])
    assert_same_text(jr, pr)
    assert jr[0] == 0
    assert "group list: 12 entries" in jr[2]
    assert "channel map: 2 entries" in jr[2]
    assert "key 001A: 123456789" in jr[2]


def test_auto_mode_on_the_dmr_capture(caps, tmp_path):
    jr, pr = both(tmp_path, ["-fa", "--iq-replay", caps["dmr"]])
    assert_same_text(jr, pr)
    assert "DMR" in jr[2]


def test_probe_iq_info_print_config_calc_lcn(caps, tmp_path):
    outs = []
    for argv in (["-f1", "--probe", "--iq-replay", caps["p25"]],
                 ["--iq-info", caps["dmr"]],
                 ["--print-config", "--iq-replay", caps["p25"]],
                 ["--print-config", "--config", caps["ini"], "--profile",
                  "quiet", "--iq-replay", caps["p25"]],
                 ["--calc-lcn", caps["freqs"]],
                 ["--calc-lcn", caps["freqs"], "--calc-cc-freq", "851.0375",
                  "--calc-cc-lcn", "7"]):
        jr, pr = both(tmp_path, argv)
        assert_same_text(jr, pr)
        assert jr[0] == 0 and jr[1]
        outs.append(pr[1])
    assert outs[0].startswith("probe: mode=p25p1 snr=")
    assert "samples: 192000" in outs[1]
    assert "deemph = off" in outs[2]
    assert "deemph = 75" in outs[3] and "snr_sql_db = 12.5" in outs[3]
    assert outs[4] != outs[5]


def test_iq_info_on_a_journalled_capture(tmp_path):
    """``--iq-info`` on a capture with a retune journal: the JAX CLI
    reads ``IqEvent`` fields that do not exist and raises; the port
    prints each event."""
    from dsdneo_tpu_torch.io.iq import IqCaptureWriter
    path = str(tmp_path / "j.iq")
    with IqCaptureWriter(path, IqMetadata(sample_format="cf32")) as w:
        w.submit(np.zeros(100, np.complex64))
        w.record_event("retune", center_frequency_hz=851_012_500)
    with pytest.raises(AttributeError):
        run(J.main, ["--iq-info", path], str(tmp_path))
    rc, so, _ = run(P.main, ["--iq-info", path], str(tmp_path))
    assert rc == 0
    assert so.splitlines()[-1] == \
        "event @800: retune center_frequency_hz=851012500"


def test_deemphasis_and_low_pass_on_the_wav(caps, tmp_path, monkeypatch):
    """``DSD_NEO_DEEMPH=nfm DSD_NEO_AUDIO_LPF=3400``: the port runs the
    two one-pole filters as one cascade on a tensor (K8 on the card),
    the JAX CLI as two calls; the WAVs agree, and differ from the raw
    decode's."""
    raw = str(tmp_path / "raw.wav")
    run(P.main, ["--platform", "cpu", "-f1", "--iq-replay", caps["p25"],
                 "-o", "wav:" + raw], str(tmp_path))
    monkeypatch.setenv("DSD_NEO_DEEMPH", "nfm")
    monkeypatch.setenv("DSD_NEO_AUDIO_LPF", "3400")
    jr, pr = both(tmp_path / "cond", ["-f1", "--iq-replay", caps["p25"],
                                      "-o", "wav:{out}/out.wav",
                                      "-g", "30"])
    assert_same_text(jr, pr)
    a, b = os.path.join(jr[3], "out.wav"), os.path.join(pr[3], "out.wav")
    assert_wav_close(a, b)
    assert float(np.max(np.abs(wav_frames(raw) - wav_frames(b)))) > 0.01


def _rtl_payload(seconds: int, cfo_hz: float = 0.0, scale: float = 1.0
                 ) -> bytes:
    """The P25 call as an rtl_tcp server streams it (CU8), with a carrier
    offset and a level."""
    from dsdneo_tpu_torch.engine import livevec as LV
    x = SV.p25_iq(SV.vector(), seconds * 4800)
    x = x * np.exp(2j * np.pi * cfo_hz * np.arange(x.shape[0]) / 48000.0)
    return LV.cu8((x * scale).astype(np.complex64))


class _Posts:
    """A local HTTP server counting the multipart POSTs it is sent."""

    def __init__(self):
        import http.server
        import threading
        self.bodies = []
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                outer.bodies.append(self.rfile.read(n))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def wait(self, n: int, timeout: float = 30.0) -> int:
        import time
        t0 = time.time()
        while len(self.bodies) < n and time.time() - t0 < timeout:
            time.sleep(0.05)
        return len(self.bodies)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _norm_port(text: str) -> str:
    import re
    return re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT", text)


def _wizard_answers(monkeypatch, answers):
    import builtins

    def scripted(prompt=""):
        for key, v in answers.items():
            if prompt.startswith(key):
                return v
        return ""
    monkeypatch.setattr(builtins, "input", scripted)


def _live(argv, payload, monkeypatch, tmp_path, stdout=False):
    """The port's CLI on ``-i rtltcp:`` against the fake server: (exit
    code, stderr, the commands the server received), with its stdout
    after the exit code where ``stdout``."""
    from dsdneo_tpu_torch.io import rtl_tcp as PR
    monkeypatch.setenv("DSDNEO_RTLTCP_RATE", "48000")
    monkeypatch.setenv("DSD_NEO_DISABLE_FS4_SHIFT", "1")
    srv = PR.FakeRtlTcpServer(payload)
    try:
        rc, so, se = run(P.main, ["--platform", "cpu", "-f1", "-i",
                                  f"rtltcp:127.0.0.1:{srv.port}:851000000",
                                  "--duration", "6"] + argv, str(tmp_path))
    finally:
        srv.close()
    return (rc, so, se, list(srv.commands)) if stdout else \
        (rc, se, list(srv.commands))


FORMERLY_REFUSED = ["frontend-http", "frontend-terminal", "N", "wizard",
                    "rdio-api-url", "auto-ppm", "tuner-autogain",
                    "m17-stream", "m17-packet-sms", "m17-bert", "m17-dat"]


@pytest.mark.parametrize("case", FORMERLY_REFUSED)
def test_formerly_refused_flags_run_their_branch(caps, tmp_path,
                                                 monkeypatch, case):
    """Each flag the port's CLI refused until its branch was ported now
    runs that branch on ``--platform cpu``.  Where the JAX CLI runs the
    same input (every case but the two live-tuner ones, which need its
    engine on a socket), the port's lines (the HTTP port the OS picked
    read as ``PORT``) and files equal the JAX CLI's."""
    p25 = ["-f1", "--iq-replay", caps["p25"]]
    if case in ("auto-ppm", "tuner-autogain"):
        from dsdneo_tpu_torch.io import rtl_tcp as PR
        if case == "auto-ppm":
            rc, se, cmds = _live(["--auto-ppm"], _rtl_payload(4, 1500.0),
                                 monkeypatch, tmp_path)
            ppm = [v for c, v in cmds if c == PR.CMD_SET_FREQ_CORRECTION]
            # the 1.5 kHz offset (1.76 ppm at 851 MHz) asks a negative
            # step of the loop's largest size, −2 (signed on the wire)
            assert ppm and ppm[0] == (-2) & 0xFFFFFFFF
        else:
            monkeypatch.setenv("DSD_NEO_TUNER_AUTOGAIN", "1")
            rc, se, cmds = _live([], _rtl_payload(2, scale=4.0),
                                 monkeypatch, tmp_path)
            assert (PR.CMD_SET_GAIN, 300) in cmds     # seeded at 30 dB
        assert rc == 0 and "NAC/CC: 293" not in se
        return
    posts = None
    if case == "frontend-http":
        argv = p25 + ["--stream", "0.5", "--frontend", "http",
                      "--http-port", "0", "--iq-replay-rate", "40"]
    elif case == "frontend-terminal":
        argv = p25 + ["--frontend", "terminal"]
    elif case == "N":
        argv = p25 + ["-N", "-o", "wav:{out}/n.wav"]
    elif case == "wizard":
        _wizard_answers(monkeypatch, {"mode": "2", "I/Q": caps["p25"],
                                      "audio": "wav:w.wav"})
        argv = ["--wizard"]
    elif case == "rdio-api-url":
        posts = _Posts()
        argv = p25 + ["--calls-dir", "{out}/calls", "--rdio-api-url",
                      f"http://127.0.0.1:{posts.port}/api/call-upload",
                      "--rdio-api-key", "k", "--rdio-system-id", "9"]
    elif case == "m17-stream":
        argv = ["-fZ", "-M", "M17:7:AB1CD:ALL", "-o", "iq:{out}/s.iq"]
    elif case == "m17-packet-sms":
        argv = ["-fP", "--m17-sms", "hello", "-o", "iq:{out}/s.iq"]
    elif case == "m17-bert":
        argv = ["-fB", "--tx-frames", "8", "-o", "iq:{out}/s.iq"]
    else:          # -M without a transmit mode: a plain decode
        argv = p25 + ["-M", "M17:7:AB1CD:ALL", "--m17-sms", "hi"]
    try:
        jr, pr = both(tmp_path, argv)
        if posts is not None:
            n = len(os.listdir(os.path.join(pr[3], "calls")))
            # the JAX CLI leaves its uploader's worker running: wait for
            # both packages' posts (one a call: the WAV and its sidecar
            # make two files, the Rdio sidecar a third)
            assert posts.wait(2 * (n // 3)) == 2 * (n // 3) >= 2
    finally:
        if posts is not None:
            posts.close()
    assert pr[0] == jr[0] == 0
    assert _norm_port(pr[1]) == _norm_port(jr[1])
    # where curses finds no terminal the port says so in one more line
    pse = "".join(ln for ln in pr[2].splitlines(keepends=True)
                  if P.NO_TERMINAL not in ln)
    assert _norm_port(pse) == _norm_port(jr[2])
    files = sorted(os.listdir(jr[3]))
    assert sorted(os.listdir(pr[3])) == files
    for f in files:
        a, b = os.path.join(jr[3], f), os.path.join(pr[3], f)
        if f.endswith(".wav"):
            assert_wav_close(a, b)
        elif f.endswith((".iq", ".json")):
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), f
    if case == "frontend-http":
        assert "http frontend: http://127.0.0.1:PORT/" in _norm_port(pr[2])
    if case == "wizard":
        assert "dsd-neo-tpu setup wizard" in pr[2] and "w.wav" in files
    if case.startswith("m17") and case != "m17-dat":
        assert "M17 Encoder: wrote {out}/s.iq" in pr[2]
    if case in ("frontend-terminal", "N", "wizard", "m17-dat",
                "rdio-api-url"):
        assert "NAC/CC: 293" in pr[2]


@pytest.mark.parametrize("path", ["replay", "live"])
def test_terminal_frontend_says_when_it_drew_nothing(caps, tmp_path,
                                                     monkeypatch, path):
    """When curses finds no terminal, ``-N`` says so on stderr and the
    decode runs as it does without a frontend: the replay's lines, and
    on the live path the engine decoding for its ``--duration``."""
    from dsdneo_tpu_torch.ui import terminal
    monkeypatch.setattr(terminal, "run", lambda *a, **k: False)
    monkeypatch.setattr(terminal, "run_live", lambda *a, **k: False)
    if path == "replay":
        rc, _so, se = run(P.main, ["--platform", "cpu", "-f1", "--iq-replay",
                                   caps["p25"], "-N"], str(tmp_path))
        assert f"dsd-neo-tpu: {P.NO_TERMINAL}; nothing drawn" in se
        assert "NAC/CC: 293" in se
    else:
        rc, so, se, _cmds = _live(["-N"], _rtl_payload(2), monkeypatch,
                                  tmp_path, stdout=True)
        assert f"dsd-neo-tpu: {P.NO_TERMINAL}; decoding without it" in se
        assert "Sync: +P25p1" in so         # the live path's event lines
    assert rc == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("platform", [[], ["--platform", "cuda"],
                                      ["--platform", "default"]])
def test_without_a_card_the_cli_exits_naming_it(caps, tmp_path, platform):
    rc, so, se = run(P.main, platform + ["-f1", "--iq-replay", caps["p25"]],
                     str(tmp_path))
    assert rc == 1 and so == ""
    assert "needs the card" in se and "CUDA" in se
    assert "Sync" not in se


def test_platform_tpu_is_refused(caps, tmp_path):
    rc, _, se = run(P.main, ["--platform", "tpu", "-f1", "--iq-replay",
                             caps["p25"]], str(tmp_path))
    assert rc == 2 and "--platform tpu" in se


@pytest.mark.parametrize("spec", ["rtlusb:0:851000000",
                                  "soapy:driver=none:851000000"])
def test_sdr_inputs_without_their_library_exit_1(tmp_path, monkeypatch,
                                                 spec):
    """``-i rtlusb…`` / ``soapy:…`` with no librtlsdr device and no
    SoapySDR module: both CLIs print the same one line and exit 1."""
    monkeypatch.setenv("DSDNEO_RTLSDR_LIB", str(tmp_path / "missing.so"))
    jr, pr = both(tmp_path, ["-f1", "-i", spec])
    assert_same_text(jr, pr)
    assert pr[0] == 1
    assert pr[2].startswith("dsd-neo-tpu: live source unavailable: ")
