"""The port's M17 transmit path (``protocol/m17/encoder.py`` and the
CLI's ``-fZ``/``-fP``/``-fB``) against the JAX package's, on the CPU.

The encoder is host numpy in both packages: every function from
``build_lsf`` to ``encode_bert_transmission`` gives the same dibits bit
for bit over several seeds (clear, scrambled, AES-CTR and signed
streams, packets of several lengths, BERT from several PRBS states), and
``dibits_to_baseband`` the same samples within 1e-6.  Through the CLIs:
the printed lines equal, the captures equal byte for byte (data and
sidecar: the sidecar holds no wall-clock field), and each capture decodes
back through ``-fz --iq-replay`` with the port's lines equal to the JAX
CLI's: every stream frame's FN, the LSF's CAN and callsigns, the SMS
text, BERT with 0 errors.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.protocol.m17 import encoder as JE  # noqa: E402
from dsdneo_tpu_torch import cli as P  # noqa: E402
from dsdneo_tpu_torch.protocol.m17 import encoder as PE  # noqa: E402

from test_torch_cli import assert_same_text, both, run  # noqa: E402  (tests/)

PRIV = 0x51E9F0C37A2B18D4655F00AA13C2DD08B7E6419C25A3F8706D5B2E8C91437AF0


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lsf_and_frames_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    calls = ["N0CALL", "W1AW", "BROADCAST", "KC1AAA-9", "AB1CD/P"]
    dst, src = calls[seed % 5], calls[(seed + 2) % 5]
    for cs in (dst, src, "x.y-z"):
        assert PE.encode_callsign(cs) == JE.encode_callsign(cs)
    meta = bytes(rng.integers(0, 256, int(rng.integers(0, 15))).tolist())
    kw = dict(can=int(rng.integers(0, 16)), stream=bool(seed % 2),
              dt=int(rng.integers(0, 4)), meta=meta,
              enc=int(rng.integers(0, 3)), enc_st=int(rng.integers(0, 4)),
              signed_stream=bool(seed % 3 == 0))
    lsf_j, lsf_p = JE.build_lsf(dst, src, **kw), PE.build_lsf(dst, src, **kw)
    _eq(lsf_j, lsf_p)
    _eq(JE.encode_lsf_frame(lsf_j), PE.encode_lsf_frame(lsf_p))
    for fn in range(8):
        v = rng.integers(0, 2, 128).astype(np.uint8)
        _eq(JE.encode_stream_frame(lsf_j, fn % 6, fn, v, eot=fn == 7),
            PE.encode_stream_frame(lsf_p, fn % 6, fn, v, eot=fn == 7))
    chunk = rng.integers(0, 2, 200).astype(np.uint8)
    for eof, value in ((False, 3), (True, 17)):
        _eq(JE.encode_packet_frame(chunk, eof, value),
            PE.encode_packet_frame(chunk, eof, value))


@pytest.mark.parametrize("case", ["clear", "scrambler", "aes", "signed"])
@pytest.mark.parametrize("seed", [4, 5])
def test_stream_transmission_bit_for_bit(case, seed):
    rng = np.random.default_rng(seed)
    voice = rng.integers(0, 2, (int(rng.integers(3, 14)), 128)
                         ).astype(np.uint8)
    kw = {"can": int(rng.integers(0, 16))}
    if case == "scrambler":
        kw.update(enc=1, enc_st=int(rng.integers(0, 3)),
                  scrambler_seed=int(rng.integers(1, 1 << 16)))
    elif case == "aes":
        kw.update(enc=2, meta=bytes(rng.integers(0, 256, 14).tolist()),
                  aes_key=bytes(rng.integers(0, 256, 32).tolist()))
    elif case == "signed":
        kw.update(sign_key=PRIV, sign_k=int(rng.integers(1, 1 << 60)))
    a = JE.encode_stream_transmission("BROADCAST", "N0CALL", voice, **kw)
    b = PE.encode_stream_transmission("BROADCAST", "N0CALL", voice, **kw)
    _eq(a, b)
    assert b.max() <= 3


@pytest.mark.parametrize("text", ["", "hi", "Greetings from the card! " * 3,
                                  "ünïcode ✓ " * 40])
def test_packet_transmission_bit_for_bit(text):
    _eq(JE.build_sms_packet(text), PE.build_sms_packet(text))
    _eq(JE.encode_packet_transmission("W1AW", "N0CALL", text, can=2),
        PE.encode_packet_transmission("W1AW", "N0CALL", text, can=2))


@pytest.mark.parametrize("state", [1, 0x5A, 0x1FF])
def test_bert_bit_for_bit(state):
    ja, js = JE.prbs9_bits(300, state)
    pa, ps = PE.prbs9_bits(300, state)
    _eq(ja, pa)
    assert ps == js
    _eq(JE.encode_bert_transmission(7, state),
        PE.encode_bert_transmission(7, state))


@pytest.mark.parametrize("sps,dev", [(10, 0.15), (10, 0.25), (5, 0.1)])
def test_dibits_to_baseband(sps, dev):
    d = np.random.default_rng(sps).integers(0, 4, 3000).astype(np.uint8)
    a = JE.dibits_to_baseband(d, sps=sps, dev=dev)
    b = PE.dibits_to_baseband(d, sps=sps, dev=dev)
    assert b.dtype == np.complex64 and b.shape == a.shape
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_modulated_loopback_through_decode_samples():
    """Encode → 4FSK baseband → the port's serial decode on the CPU (the
    JAX test's case, with the device named): the LSF's source comes
    back."""
    from dsdneo_tpu_torch.engine.decoder import decode_samples
    rng = np.random.default_rng(1)
    voice = rng.integers(0, 2, (8, 128)).astype(np.uint8)
    x = PE.dibits_to_baseband(
        PE.encode_stream_transmission("BROADCAST", "KC1AAA", voice),
        sps=10, dev=0.15)
    pad = (rng.normal(size=500) + 1j * rng.normal(size=500)
           ).astype(np.complex64) * 0.05
    ctx = decode_samples(np.concatenate([pad, x, pad]), "m17", device="cpu")
    assert "SRC: KC1AAA" in "\n".join(e.line for e in ctx.events)


TX = {
    "stream": ["-fZ", "-M", "M17:7:N0CALL:TG1", "--tx-frames", "50"],
    "packet": ["-fP", "-M", "M17:3:AB1CD:W1AW", "--m17-sms",
               "Hello from the M17 encoder"],
    "bert": ["-fB", "--tx-frames", "50"],
}


@pytest.mark.parametrize("kind", sorted(TX))
def test_cli_transmit_then_receive(tmp_path, kind):
    jr, pr = both(tmp_path / "tx", TX[kind] + ["-o", "iq:{out}/tx.iq"])
    assert_same_text(jr, pr)
    assert pr[0] == 0 and f"wrote {{out}}/tx.iq" in pr[2]
    for f in ("tx.iq", "tx.iq.json"):
        with open(os.path.join(jr[3], f), "rb") as a, \
                open(os.path.join(pr[3], f), "rb") as b:
            assert a.read() == b.read(), f
    cap = os.path.join(pr[3], "tx.iq")
    jr, pr = both(tmp_path / "rx", ["-fz", "--iq-replay", cap])
    assert_same_text(jr, pr)
    lines = pr[2].splitlines()
    if kind == "stream":
        fns = [int(ln.split("FN: ")[1].split()[0], 16)
               for ln in lines if "STR" in ln and "FN: " in ln]
        assert fns == list(range(50))
        assert "EOT" in [ln for ln in lines if "FN: 0031" in ln][0]
        assert " CAN: 7 DST: TG1 SRC: N0CALL" in pr[2]
    elif kind == "packet":
        assert " CAN: 3 DST: W1AW SRC: AB1CD Packet" in pr[2]
        assert " SMS: Hello from the M17 encoder" in lines
    else:
        brt = [ln for ln in lines if "BRT" in ln]
        assert len(brt) == 50
        assert all("errors:0" in ln for ln in brt)
        assert all("LOCK" in ln for ln in brt[1:])


def test_cli_transmit_without_iq_output_exits_2(tmp_path):
    rc, _, se = run(P.main, ["-fZ", "-o", "wav:x.wav"], str(tmp_path))
    assert rc == 2 and "use -o iq:PATH" in se
