"""The port's CLI (``python -m dsdneo_tpu_torch``) against the JAX
package's (``dsdneo_tpu.cli``), both run in process with ``--platform
cpu`` on the same captures, written by the port's ``io.iq`` from the
vectors of ``data/serial_tables.npz`` (``engine/serialvec``): 4 s of the
P25 call and 4 s of the DMR stream's Basic Privacy window at 48 kHz.

Equal means: the printed lines (stdout and stderr, each package's own
output directory replaced by one name), the event log (``-J``), the
frame log, the ``.imb`` file byte for byte, the call records
(``--calls-dir``: every field; the sidecar holds no wall-clock time, the
Rdio sidecar that would is not ported) and every WAV within 2e-3 of its
peak.  Each flag whose branch is not ported exits 2 with one line naming
its ``ROADMAP.md`` item.
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


DEFERRED = [
    (["--frontend", "http"], "5a"),
    (["--frontend", "terminal"], "5b"),
    (["-N"], "5b"),
    (["--wizard"], "6a"),
    (["--rdio-api-url", "http://127.0.0.1:1/api"], "6a"),
    (["--auto-ppm"], "6a"),
    (["-fZ", "-M", "M17:7:AB1CD:ALL", "-o", "iq:x.iq"], "6b"),
    (["--m17-sms", "hello"], "6b"),
]


@pytest.mark.parametrize("argv,item", DEFERRED,
                         ids=[" ".join(a[:2]) for a, _ in DEFERRED])
def test_deferred_flags_exit_2_naming_their_item(caps, tmp_path, argv,
                                                 item):
    rc, so, se = run(P.main, ["--platform", "cpu", "--iq-replay",
                              caps["p25"]] + argv, str(tmp_path))
    assert rc == 2 and so == ""
    assert se.count("\n") == 1
    assert f"(ROADMAP.md queue 1, item {item})" in se


def test_tuner_autogain_on_a_live_sdr_exits_2(tmp_path, monkeypatch):
    monkeypatch.setenv("DSD_NEO_TUNER_AUTOGAIN", "1")
    rc, _, se = run(P.main, ["--platform", "cpu", "-i",
                             "rtltcp:127.0.0.1:1"], str(tmp_path))
    assert rc == 2 and "DSD_NEO_TUNER_AUTOGAIN" in se and "item 6a" in se


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
