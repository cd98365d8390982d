"""``detect_mode``, ``decode_samples(..., "auto")`` and ``decode_capture``
of the PyTorch port against the JAX package's, on the CPU; with the
resampler, the I/Q capture reader and writer, and ECDSA P-256.

  - ``detect_mode`` on 4 s of each family's stream of
    ``data/serial_tables.npz`` (P25p1, EDACS/ProVoice, DMR, X2-TDMA,
    NXDN48, NXDN96, dPMR, YSF, D-STAR, M17, P25p2) picks the JAX
    package's ``ModeConfig``; ``decode_samples(..., "auto")`` gives the
    JAX package's events;
  - ``decode_capture`` on cs16 captures the port writes
    (``io.write_iq_capture``) after its resampler raised the stream from
    48 kHz: at 48 kHz, at 96 kHz (resampled back to 48 kHz, and with
    ``DSD_NEO_RESAMP=off`` decoded at 96 kHz), at 44.1 kHz (L/M =
    160/147): the JAX package's events;
  - ``dsp.resampler.resample`` bit for bit (tolerance 0) against the
    JAX function, float and complex, over six rate pairs;
    ``read_iq_capture`` bit for bit on random bytes of every sample
    format in both I/Q orders, read by its data file and by its sidecar,
    and ``write_iq_capture`` byte for byte;
  - ``crypto.ecdsa``: the same signatures, verified, and bad ones (a
    flipped bit of the signature or the digest, a key off the curve, r
    = 0) refused by both;
  - in ``detect_mode`` a device error propagates (a CUDA error of the
    front end, running out of memory in a synthesis) where an error of a
    host decoder skips the mode as in the JAX package; the entry points
    take the card when no device is given.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none

import jax.numpy as jnp  # noqa: E402

from dsdneo_tpu.crypto import ecdsa as jecdsa  # noqa: E402
from dsdneo_tpu.dsp import resampler as jres  # noqa: E402
from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.io import iq as jiq  # noqa: E402
from dsdneo_tpu.protocol.p25 import phase1 as jp1  # noqa: E402
from dsdneo_tpu.runtime import config as jcfg  # noqa: E402
from dsdneo_tpu_torch.crypto import ecdsa as tecdsa  # noqa: E402
from dsdneo_tpu_torch.dsp import resampler as tres  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.io import iq as tiq  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import phase1 as tp1  # noqa: E402
from dsdneo_tpu_torch.runtime import config as tcfg  # noqa: E402
from dsdneo_tpu_torch.vocoder import synth  # noqa: E402

FS = 48000
RATES = [(48000, 96000), (96000, 48000), (44100, 48000), (48000, 44100),
         (62500, 48000), (250000, 48000)]


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    """Both packages read the environment afresh in each test."""
    monkeypatch.setattr(jcfg, "_config", None)
    monkeypatch.setattr(tcfg, "_config", None)


def _probe(family: str) -> np.ndarray:
    """4 s of ``family``'s stream, 48 kHz."""
    return SV.auto_probe(SV.vector(), family)


FAMILIES = list(SV.AUTO_FAMILIES)


@pytest.mark.parametrize("family", FAMILIES)
def test_detect_mode_against_jax(family):
    x = _probe(family)
    j = jdec.detect_mode(x)
    t = tdec.detect_mode(x, device="cpu")
    assert t.name == j.name
    # the pick stored beside the streams, which the card is judged on
    assert t.name == SV.auto_pick(SV.vector(), family)


@pytest.mark.parametrize("family", ["m17", "p25p1"])
def test_decode_samples_auto_against_jax(family):
    x = _probe(family)
    tv = SV.vector()
    kw = {"state_attrs": SV.m17_attrs(tv)} if family == "m17" else {}
    j = jdec.decode_samples(x, "auto", **kw)
    t = tdec.decode_samples(x, "auto", device="cpu", **kw)
    assert t.mode_name == j.mode_name
    assert SV.events_equal(j.events, t.events) is None, \
        SV.events_equal(j.events, t.events)
    assert len(t.events) >= 50


def _capture(tmp_path, x: np.ndarray, rate: int) -> str:
    """``x`` (48 kHz) resampled to ``rate`` by the port and written as a
    cs16 capture; returns its data file's path."""
    if rate != FS:
        x = tres.resample(torch.from_numpy(x), FS, rate).numpy()
    path = os.path.join(str(tmp_path), f"cap_{rate}.iq")
    tiq.write_iq_capture(path, 0.5 * x, tiq.IqMetadata(
        sample_format="cs16", sample_rate_hz=rate))
    return path


@pytest.mark.parametrize("rate,mode,resamp", [
    (48000, "p25p1", None), (96000, "p25p1", None), (44100, "p25p1", None),
    (96000, "m17", None), (96000, "p25p1", "off")])
def test_decode_capture_against_jax(tmp_path, monkeypatch, rate, mode,
                                    resamp):
    tv = SV.vector()
    if resamp is not None:
        monkeypatch.setenv("DSD_NEO_RESAMP", resamp)
    x = _probe(mode)
    path = _capture(tmp_path, x, rate)
    kw = {"state_attrs": SV.m17_attrs(tv)} if mode == "m17" else {}
    j = jdec.decode_capture(path, mode, **kw)
    t = tdec.decode_capture(path, mode, device="cpu", **kw)
    assert SV.events_equal(j.events, t.events) is None, \
        SV.events_equal(j.events, t.events)
    assert len(t.events) >= 40
    np.testing.assert_array_equal(j.debug_iq, t.debug_iq)
    for slot in j.audio:
        a, b = SV.pcm(j, slot), SV.pcm(t, slot)
        assert a.shape == b.shape
        # libcodec2 keeps one noise generator for the whole process, so
        # two M17 decodes in one process differ in their unvoiced noise:
        # M17's PCM is compared in fresh processes in
        # test_torch_m17_serial.py
        if mode != "m17":
            assert np.abs(a - b).max() <= 2e-3 * np.abs(a).max()


@pytest.mark.parametrize("rates", RATES)
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_resample_bit_for_bit(rates, kind):
    rng = np.random.default_rng(rates[0] % 997)
    x = rng.normal(size=(2, 20001)).astype(np.float32)
    if kind == "complex":
        x = (x[0] + 1j * x[1]).astype(np.complex64)
    j = np.asarray(jres.resample(jnp.asarray(x), *rates))
    t = tres.resample(torch.from_numpy(x), *rates).numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(j, t)      # tolerance 0


@pytest.mark.parametrize("fmt", ["cu8", "cs16", "cf32"])
@pytest.mark.parametrize("order", ["IQ", "QI"])
def test_read_and_write_iq_capture(tmp_path, fmt, order):
    rng = np.random.default_rng(len(fmt) + len(order))
    raw = rng.integers(0, 256, 4 * 3001 + 2).astype(np.uint8).tobytes()
    if fmt == "cf32":
        raw = rng.normal(size=2 * 3001).astype("<f4").tobytes()
    data = os.path.join(str(tmp_path), "raw.iq")
    with open(data, "wb") as f:
        f.write(raw)
    meta = jiq.IqMetadata(sample_format=fmt, iq_order=order,
                          sample_rate_hz=62500, data_file="raw.iq")
    with open(data + ".json", "w") as f:
        json.dump(meta.to_json_dict(), f)
    for path in (data, data + ".json"):
        mj, sj = jiq.read_iq_capture(path)
        mt, st = tiq.read_iq_capture(path)
        assert mj.to_json_dict() == mt.to_json_dict()
        assert sj.dtype == st.dtype == np.complex64
        np.testing.assert_array_equal(sj, st)
    np.testing.assert_array_equal(jiq._decode_samples(raw, fmt, order),
                                  tiq._decode_samples(raw, fmt, order))
    # the writers give the same bytes and sidecar
    x = sj[:2000] * 0.9
    outs = []
    for mod, name in ((jiq, "j.iq"), (tiq, "t.iq")):
        p = os.path.join(str(tmp_path), name)
        mod.write_iq_capture(p, x, mod.IqMetadata(sample_format=fmt,
                                                  iq_order=order))
        with open(p, "rb") as f, open(p + ".json") as g:
            side = json.load(g)
            side.pop("data_file")
            outs.append((f.read(), side))
    assert outs[0] == outs[1]


def test_ecdsa_against_jax():
    rng = np.random.default_rng(8)
    for _ in range(3):
        priv = int.from_bytes(rng.bytes(31), "big") + 1
        k = int.from_bytes(rng.bytes(31), "big") + 1
        digest = rng.bytes(16)
        pub = tecdsa.p256_public_key(priv)
        assert pub == jecdsa.p256_public_key(priv)
        sig = tecdsa.p256_sign_digest(digest, priv, k)
        assert sig == jecdsa.p256_sign_digest(digest, priv, k)
        assert tecdsa.on_curve(int.from_bytes(pub[:32], "big"),
                               int.from_bytes(pub[32:], "big"))
        bad_sig = bytes([sig[0] ^ 1]) + sig[1:]
        bad_dig = bytes([digest[0] ^ 0x80]) + digest[1:]
        off_curve = pub[:63] + bytes([pub[63] ^ 1])
        for d, p, s, want in ((digest, pub, sig, True),
                              (digest, pub, bad_sig, False),
                              (bad_dig, pub, sig, False),
                              (digest, off_curve, sig, False),
                              (digest, pub, bytes(32) + sig[32:], False),
                              (digest, pub[:32], sig, False)):
            assert tecdsa.p256_verify_digest(d, p, s) is want
            assert jecdsa.p256_verify_digest(d, p, s) is want


def test_device_error_in_detect_mode_propagates(monkeypatch):
    x = _probe("p25p1")

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(tdec, "demod_fm", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tdec.detect_mode(x, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        tdec.decode_samples(x, "auto", device="cpu")


def test_out_of_memory_in_synthesis_propagates(monkeypatch):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(synth, "synthesize_frames", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tdec.detect_mode(_probe("p25p1"), device="cpu")


def test_host_decoder_error_skips_the_mode(monkeypatch):
    def fails(self, reader, hit, ctx):
        raise ValueError("a host decoder's fault")

    monkeypatch.setattr(jp1.P25P1Decoder, "handle", fails)
    monkeypatch.setattr(tp1.P25P1Decoder, "handle", fails)
    x = _probe("p25p1")
    j = jdec.detect_mode(x)
    t = tdec.detect_mode(x, device="cpu")
    assert t.name == j.name != "p25p1"


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = _probe("p25p1")
    path = _capture(tmp_path, x, FS)
    for call in (lambda: tdec.detect_mode(x),
                 lambda: tdec.decode_samples(x, "auto"),
                 lambda: tdec.decode_capture(path, "p25p1")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
