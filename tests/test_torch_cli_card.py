"""The port's CLI and live path on the card against its CPU path.

``python -m dsdneo_tpu_torch`` (``cli.main``) with its default platform
(the card) and with ``--platform cpu`` on the same captures: 4 s of the
P25 call with every file output and the decoded-audio conditioning
(``DSD_NEO_DEEMPH=nfm DSD_NEO_AUDIO_LPF=3400``, which on the card is
one launch of K8 a slot), and ``--trunk-wideband`` on 2.5 s of the JAX
bench's fleet cell (K1 and K4 on the control row, K2 on the voice row,
K8 on the rows' PCM).  ``LiveEngine(device="cuda")`` runs the closed
loop of ``engine/livevec`` (one tuner following the bench's grant).

Equal means: the printed lines, the event and frame logs, the ``.imb``
bytes, the tunes and events, every LDU of the followed call exact, and
PCM within 2e-3 of the CPU path's peak.  Every test needs a card
(``cuda`` marker; skips without one) and none imports JAX, so this file
runs on the card's machine: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_cli_card.py``.  The CPU path is held to the JAX package
by ``test_torch_cli.py``, ``test_torch_cli_fleet.py`` and
``test_torch_live.py``.
"""

import contextlib
import io
import os
import wave

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import cli
from dsdneo_tpu_torch.dsp import audio_filters as af
from dsdneo_tpu_torch.engine import fleetvec as FV
from dsdneo_tpu_torch.engine import live, livevec, trunk
from dsdneo_tpu_torch.engine import serialvec as SV
from dsdneo_tpu_torch.fec import device as fdev
from dsdneo_tpu_torch.io import IqMetadata, write_iq_capture
from dsdneo_tpu_torch.ops import fir_discriminate as k1mod
from dsdneo_tpu_torch.vocoder import device as vdev

PCM_REL = 2e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _run(argv, cwd):
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
    finally:
        os.chdir(here)
    return rc, out.getvalue().replace(cwd, "{out}"), \
        err.getvalue().replace(cwd, "{out}")


def _card_and_cpu(tmp_path, argv):
    """``argv`` with the default platform and with ``--platform cpu``
    (``{out}``: each run's directory); K1, K2, K4 and K8 launches of the
    card's run."""
    counted = (k1mod.fir_discriminate, vdev.prediction_scan,
               fdev.p25_12_decode_batch, af.one_pole)
    res = {}
    for name, extra in (("card", []), ("cpu", ["--platform", "cpu"])):
        d = str(tmp_path / name)
        for fn in counted:
            fn.launches = 0
        rc, so, se = _run(extra + [a.replace("{out}", d) for a in argv], d)
        res[name] = (rc, so, se, d, [fn.launches for fn in counted])
    return res["card"], res["cpu"]


def _wav(path):
    with wave.open(path, "rb") as w:
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        return x.astype(np.float32).reshape(-1, w.getnchannels()) / 32768.0


def _close(a, b):
    x, y = _wav(a), _wav(b)
    assert x.shape == y.shape and x.size
    assert float(np.max(np.abs(x - y))) <= PCM_REL * float(np.max(np.abs(x)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.cuda
def test_cli_default_platform_takes_the_card(tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("DSD_NEO_DEEMPH", "nfm")
    monkeypatch.setenv("DSD_NEO_AUDIO_LPF", "3400")
    tv = SV.vector()
    cap = str(tmp_path / "p25.iq")
    write_iq_capture(cap, SV.p25_iq(tv, 4 * 4800),
                     IqMetadata(sample_format="cf32", sample_rate_hz=48000))
    card, cpu = _card_and_cpu(tmp_path, [
        "-f1", "--iq-replay", cap, "-o", "wav:{out}/out.wav",
        "-J", "{out}/events.log", "--frame-log", "{out}/frames.log",
        "--mbe-out", "{out}/voice.imb"])
    assert card[:3] == cpu[:3] and card[0] == 0
    for f in ("events.log", "frames.log", "voice.imb"):
        assert _read(os.path.join(card[3], f)) == \
            _read(os.path.join(cpu[3], f)), f
    _close(os.path.join(cpu[3], "out.wav"), os.path.join(card[3], "out.wav"))
    assert card[4][3] == 1                      # K8: one slot, one launch
    assert cpu[4] == [0, 0, 0, 0]


@pytest.mark.cuda
def test_cli_trunk_wideband_on_the_card(tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("DSD_NEO_DEEMPH", "nfm")
    monkeypatch.setenv("DSD_NEO_AUDIO_LPF", "3400")
    band = FV.bench_band(FV.vector(), seconds=2.5).numpy()
    cap = str(tmp_path / "band.iq")
    write_iq_capture(cap, band, IqMetadata(
        sample_format="cf32", sample_rate_hz=int(FV.BENCH_FS),
        center_frequency_hz=int(FV.BENCH_CENTER)))
    card, cpu = _card_and_cpu(tmp_path, [
        "--iq-replay", cap, "--trunk-wideband",
        f" {FV.BENCH_CC_OFF}:4:p25p1", "-o", "wav:{out}/voice.wav"])
    assert card[:3] == cpu[:3] and card[0] == 0
    assert "GRANT TG 101" in card[2]
    _close(os.path.join(cpu[3], "voice.wav"),
           os.path.join(card[3], "voice.wav"))
    k1, k2, k4, k8 = card[4]
    assert k1 >= 3 and k2 >= 1 and k4 >= 3 and k8 >= 1


@pytest.mark.cuda
def test_closed_loop_on_the_card():
    dev = _card()
    tv = FV.vector()
    loops = {}
    for d in (dev, "cpu"):
        loop = livevec.ClosedLoop(live.LiveEngine, trunk.TrunkSM,
                                  trunk.TrunkFollower, SV.ImbeSink(),
                                  engine_kw={"device": d})
        loop.run(tv)
        livevec.judge(loop, tv)
        loops[str(d)] = loop
    g, c = loops[str(dev)], loops["cpu"]
    assert g.tunes == c.tunes and g.events == c.events
    a, b = SV.pcm(c.eng.decoder.ctx), SV.pcm(g.eng.decoder.ctx)
    assert a.shape == b.shape and a.size
    assert float(np.max(np.abs(a - b))) <= PCM_REL * float(np.max(np.abs(a)))
