"""The port's CLI against the JAX package's on its streamed and file
branches, both in process with ``--platform cpu``: ``--stream`` (equal
to both CLIs' one-shot decode, and with ``--iq-loop``,
``--input-volume`` and ``--iq-replay-rate``), the raw PCM and UDP audio
sinks (``-o pcm:``, ``-o udp:``), and a discriminator-tap WAV file as
live input (``-i file.wav``, the stream decoder's ``disc`` input).  Then
the port's CLI alone on its socket inputs, judged by the decoded events:
``-i tcp:...`` (its printed lines equal to the JAX CLI's on the same
bytes read from a WAV), ``-i rtltcp:...`` with trunk following, a scan
list, a rigctl tuner and ``--iq-capture`` (on both lossless transports
every LDU of the 2 s sent decodes, its IMBE frames the vector's clear
voice bit for bit), and ``-i udp:PORT`` (datagrams a loaded host may
drop: a floor of LDUs).

Equal means: the printed lines (each package's own output directory
replaced by one name), the PCM file and the UDP datagrams within 2e-3
of their peak (as int16 codes, one code apart at most where the float
PCM straddles a step), the WAV within 2e-3 of its peak.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu import cli as J  # noqa: E402
from dsdneo_tpu_torch import cli as P  # noqa: E402
from dsdneo_tpu_torch.engine import livevec as LV  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.engine import stream as ST  # noqa: E402
from dsdneo_tpu_torch.io import rtl_tcp as PR  # noqa: E402
from dsdneo_tpu_torch.io.audio_files import write_wav  # noqa: E402
from dsdneo_tpu_torch.io.iq import IqMetadata, write_iq_capture  # noqa: E402
from test_torch_cli import (assert_same_text, assert_wav_close,  # noqa: E402,E501  (tests/)
                            both, run)
from test_torch_live import _disc_pcm, _free_udp_port  # noqa: E402  (tests/)

PCM_REL = 2e-3


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    tv = SV.vector()
    out = {}
    for name, n in (("p25", 4 * 4800), ("p25_2s", 2 * 4800)):
        path = str(d / f"{name}.iq")
        write_iq_capture(path, SV.p25_iq(tv, n), IqMetadata(
            sample_format="cf32", sample_rate_hz=48000))
        out[name] = path
    out["wav"] = str(d / "disc.wav")
    write_wav(out["wav"], _disc_pcm(SV.p25_iq(tv, 2 * 4800)), 48000)
    kid, key = int(tv["p25_ids"][4]), int(tv["p25_ids"][3])
    out["keys"] = str(d / "keys.csv")
    with open(out["keys"], "w") as f:               # the ADP key, decimal
        f.write(f"id,key\n{kid},{key}\n")
    return out


def _imbe_sinks(monkeypatch) -> list:
    """Give every ``StreamDecoder`` the port builds from here on an IMBE
    frame sink (the live path writes no ``.imb``); returns the sinks."""
    sinks = []
    init = ST.StreamDecoder.__init__

    def with_sink(self, *a, **kw):
        init(self, *a, **kw)
        self.ctx.mbe_sink = SV.ImbeSink()
        sinks.append(self.ctx.mbe_sink)

    monkeypatch.setattr(ST.StreamDecoder, "__init__", with_sink)
    return sinks


def assert_every_ldu_exact(sinks, seconds: float) -> None:
    """The live decoder's IMBE frames are the call's clear voice (the ADP
    superframes decrypted with the key), all nine of every LDU that
    lies whole in the first ``seconds`` sent."""
    tv = SV.vector()
    n_ldu = int(np.sum(tv["p25_ldu_pos"] + SV.P25_LDU_DIBITS
                       <= seconds * 4800))
    clear = np.unpackbits(tv["p25_clear88"], axis=-1)[..., :88]
    assert len(sinks) == 1 and n_ldu >= 10
    got = np.asarray(sinks[0].bits, np.uint8).reshape(-1, 88)
    np.testing.assert_array_equal(got, clear.reshape(-1, 88)[:9 * n_ldu])


def assert_pcm16_close(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and a.size
    peak = float(np.max(np.abs(a.astype(np.int32)))) or 1.0
    assert float(np.max(np.abs(a.astype(np.int32) - b))) <= max(
        PCM_REL * peak, 1.0)


def test_stream_equals_one_shot(caps, tmp_path):
    """``--stream 0.25`` in both packages, and the one-shot decode: the
    same printed lines and WAV."""
    one_j, one_p = both(tmp_path / "one", [
        "-f1", "--iq-replay", caps["p25"], "-o", "wav:{out}/out.wav"])
    st_j, st_p = both(tmp_path / "stream", [
        "-f1", "--iq-replay", caps["p25"], "-o", "wav:{out}/out.wav",
        "--stream", "0.25"])
    assert_same_text(st_j, st_p)
    assert_same_text(one_j, one_p)
    assert st_p[2] == one_p[2]
    for r in (st_p, one_j, one_p):
        assert_wav_close(os.path.join(st_j[3], "out.wav"),
                         os.path.join(r[3], "out.wav"))


def test_stream_loop_volume_and_pacing(caps, tmp_path):
    """``--stream`` over two loops of the capture at 0.8 of its level,
    paced at 40 times realtime, into the raw PCM sink."""
    jr, pr = both(tmp_path, [
        "-f1", "--iq-replay", caps["p25_2s"], "--stream", "0.3",
        "--iq-loop", "2", "--input-volume", "0.8",
        "--iq-replay-rate", "40", "-o", "pcm:{out}/out.pcm"])
    assert_same_text(jr, pr)
    assert pr[2].count("LDU1 VOICE") >= 8
    a, b = (np.fromfile(os.path.join(r[3], "out.pcm"), "<i2")
            for r in (jr, pr))
    assert_pcm16_close(a, b)


def test_udp_audio_sink(caps, tmp_path):
    """``-o udp:HOST:PORT``: the decoded PCM as PCM16LE datagrams."""
    got = {}
    for name, main in (("jax", J.main), ("port", P.main)):
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(0.2)
        chunks = []
        done = threading.Event()

        def recv():
            # until the CLI has returned and the socket is quiet
            while True:
                try:
                    chunks.append(rx.recv(65536))
                except socket.timeout:
                    if done.is_set():
                        return
                except OSError:
                    return

        t = threading.Thread(target=recv, daemon=True)
        t.start()
        rc, so, se = run(main, ["--platform", "cpu", "-f1", "--iq-replay",
                                caps["p25_2s"], "-o",
                                f"udp:127.0.0.1:{rx.getsockname()[1]}"],
                         str(tmp_path / name))
        done.set()
        t.join(timeout=10)
        assert not t.is_alive()
        rx.close()
        assert rc == 0
        got[name] = (so, se, np.frombuffer(b"".join(chunks), "<i2"),
                     [len(c) for c in chunks])
    (jo, je, ja, jl), (po, pe, pa, pl) = got["jax"], got["port"]
    assert (po, pe) == (jo, je)
    assert pl == jl and set(pl[:-1]) == {640}
    assert_pcm16_close(ja, pa)


def test_wav_file_input(caps, tmp_path):
    """``-i disc.wav``: 2 s of the P25 call's discriminator tap as a
    48 kHz WAV, decoded by the stream decoder's ``disc`` input; the
    events are printed to stdout."""
    jr, pr = both(tmp_path, ["-f1", "-i", caps["wav"]])
    assert_same_text(jr, pr)
    assert pr[0] == 0 and "NAC/CC: 293" in pr[1]
    assert pr[1].count("VOICE (9 IMBE frames)") >= 8


def test_cli_udp_pcm_live_input(capsys):
    """``python -m dsdneo_tpu_torch -f1 -i udp:PORT``: 2 s of the P25
    call's discriminator audio as PCM16LE datagrams, paced at realtime
    so a loaded host drops none, decode through the port's CLI (the case
    of ``tests/test_live_input.py``); the input ends the run 1 s after
    the last datagram."""
    tv = SV.vector()
    pcm = _disc_pcm(SV.p25_iq(tv, 2 * 4800))
    port = _free_udp_port()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def blast():
        time.sleep(0.7)                   # let the receiver bind
        for i in range(0, len(pcm), 1200):
            sock.sendto(pcm[i:i + 1200].tobytes(), ("127.0.0.1", port))
            time.sleep(0.025)

    t = threading.Thread(target=blast, daemon=True)
    t.start()
    rc = P.main(["--platform", "cpu", "-f1", "-i", f"udp:{port}",
                   "--duration", "20"])
    t.join(timeout=10)
    sock.close()
    assert rc == 0
    out = capsys.readouterr().out
    assert "NAC/CC: 293" in out
    assert out.count("VOICE (9 IMBE frames)") >= 6


def test_cli_tcp_pcm_live_input(caps, tmp_path, monkeypatch):
    """``-i tcp:HOST:PORT``: a TCP server streams 2 s of the call's
    discriminator tap as PCM16LE; the connection's end ends the run.
    TCP loses nothing, so the printed lines equal the JAX CLI's on the
    same samples read from a WAV, and every LDU's IMBE frames are the
    vector's."""
    pcm = _disc_pcm(SV.p25_iq(SV.vector(), 2 * 4800)).tobytes()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10)

    def serve():
        conn, _ = srv.accept()
        with conn:
            for i in range(0, len(pcm), 9600):
                conn.sendall(pcm[i:i + 9600])
                time.sleep(0.02)
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    sinks = _imbe_sinks(monkeypatch)
    rc, so, se = run(P.main, ["--platform", "cpu", "-f1", "-i",
                              f"tcp:127.0.0.1:{srv.getsockname()[1]}",
                              "--duration", "20", "--keys-dec",
                              caps["keys"]], str(tmp_path / "port"))
    t.join(timeout=10)
    assert rc == 0 and not t.is_alive()
    assert_every_ldu_exact(sinks, 2.0)
    jrc, jso, _jse = run(J.main, ["--platform", "cpu", "-f1", "-i",
                                  caps["wav"], "--keys-dec", caps["keys"]],
                         str(tmp_path / "jax"))
    assert jrc == 0 and "NAC/CC: 293" in jso
    assert so == jso


def _fake_rigctl():
    """A rigctld stand-in: accepts one client, answers ``RPRT 0`` to
    every line and records them; returns (port, lines, thread)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10)
    lines = []

    def serve():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        conn.settimeout(10)
        with conn:
            buf = b""
            while True:
                try:
                    part = conn.recv(4096)
                except OSError:
                    break
                if not part:
                    break
                buf += part
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    lines.append(line.decode())
                    conn.sendall(b"RPRT 0\n")
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], lines, t


def test_cli_rtltcp_fs4_capture_shift(caps, capsys, monkeypatch, tmp_path):
    """``-i rtltcp:HOST:PORT:FREQ`` through the port's CLI with the
    default +fs/4 capture shift (the case of ``tests/test_rtl_tcp.py``):
    the server streams the P25 call as an offset-tuned tuner sees it (the
    channel at −fs/4, the CU8 codes rotated by (−j)^n exactly), the
    ring's fused widen + rotate brings it back to baseband, and the tune
    command carries the +fs/4 offset.  With ``--trunk``, a
    ``--trunk-scan`` target list, a rigctl tuner (``-U``) and
    ``--iq-capture``: the follower and scanner are wired, the rigctl
    server is reached, and the capture's sidecar is written when the
    run ends (the JAX CLI never closes the writer, so it writes none).
    rtl_tcp loses nothing: every LDU's IMBE frames are the vector's."""
    tv = SV.vector()
    raw = np.frombuffer(LV.cu8(SV.p25_iq(tv, 2 * 4800)), np.uint8)
    i, q = raw[0::2], raw[1::2]
    obs = np.empty_like(raw).reshape(-1, 2)
    k = np.arange(i.size) & 3
    obs[k == 0] = np.stack([i[k == 0], q[k == 0]], axis=1)
    obs[k == 1] = np.stack([q[k == 1], 255 - i[k == 1]], axis=1)
    obs[k == 2] = np.stack([255 - i[k == 2], 255 - q[k == 2]], axis=1)
    obs[k == 3] = np.stack([255 - q[k == 3], i[k == 3]], axis=1)
    srv = PR.FakeRtlTcpServer(obs.tobytes())
    rig_port, rig_lines, rig_t = _fake_rigctl()
    targets = tmp_path / "targets.csv"
    targets.write_text("id,type,frequency_hz\nsite-a,p25,851000000\n"
                       "site-b,p25,852000000\n")
    cap = str(tmp_path / "live.iq")
    monkeypatch.setenv("DSDNEO_RTLTCP_RATE", "48000")
    sinks = _imbe_sinks(monkeypatch)
    try:
        rc = P.main(["--platform", "cpu", "-f1", "-i",
                       f"rtltcp:127.0.0.1:{srv.port}:851000000",
                       "--duration", "5", "--trunk", "--trunk-scan",
                       str(targets), "-U", str(rig_port), "--iq-capture",
                       cap, "--keys-dec", caps["keys"]])
    finally:
        srv.close()
    rig_t.join(timeout=10)
    assert rc == 0
    cap_out = capsys.readouterr()
    out = cap_out.out
    assert "NAC/CC: 293" in out
    assert_every_ldu_exact(sinks, 2.0)
    assert out.count("VOICE (9 IMBE frames)") == 10
    assert f"trunk-scan: 2 targets from {targets}" in cap_out.err
    tuned = [v for c, v in srv.commands if c == PR.CMD_SET_FREQ]
    assert 851_012_000 in tuned          # the channel + fs/4
    assert not rig_t.is_alive() and rig_lines == []   # no grant, no tune
    with open(cap + ".json") as f:
        side = json.load(f)
    assert side["sample_format"] == "cf32" and side["sample_rate_hz"] == \
        48000
    assert side["data_bytes"] == os.path.getsize(cap) > 8 * 48000
