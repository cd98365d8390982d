"""The DMR voice ciphers of the PyTorch port against the JAX package's,
on the CPU, bit for bit (``crypto/keystream.py``'s Basic Privacy and AES,
``crypto/retevis_rc2.py``, ``crypto/pc4.py``, ``crypto/pc5.py``,
``crypto/vendor.py``, ``crypto/keyring.py``'s redaction), and
``DmrBsDecoder._synthesize`` with each cipher set: the 49 parameter bits
it hands ``decode_ambe_2450`` equal in both packages (the JAX cipher
object for the JAX decoder, the port's own, built from the same key, for
the port's), the decrypted frames equal to the clear ones, and the PCM
within 2e-3 of the JAX package's peak.  Inputs are drawn from seeds with
numpy.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.crypto import keyring as jkr  # noqa: E402
from dsdneo_tpu.crypto import keystream as jks  # noqa: E402
from dsdneo_tpu.crypto import pc4 as jpc4  # noqa: E402
from dsdneo_tpu.crypto import pc5 as jpc5  # noqa: E402
from dsdneo_tpu.crypto import retevis_rc2 as jrc2  # noqa: E402
from dsdneo_tpu.crypto import vendor as jven  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.dmr import ambe_frame as jaf  # noqa: E402
from dsdneo_tpu.protocol.dmr import bs as jbs  # noqa: E402
import dsdneo_tpu.vocoder.mbe as jmbe  # noqa: E402
from dsdneo_tpu_torch.crypto import keyring as tkr  # noqa: E402
from dsdneo_tpu_torch.crypto import keystream as tks  # noqa: E402
from dsdneo_tpu_torch.crypto import pc4 as tpc4  # noqa: E402
from dsdneo_tpu_torch.crypto import pc5 as tpc5  # noqa: E402
from dsdneo_tpu_torch.crypto import retevis_rc2 as trc2  # noqa: E402
from dsdneo_tpu_torch.crypto import vendor as tven  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr import bs as tbs  # noqa: E402
import dsdneo_tpu_torch.vocoder.mbe as tmbe  # noqa: E402

PCM_REL = 2e-3
KEY_HEX = ("0123456789ABCDEF0123456789ABCDEF",
           "FEDCBA9876543210FEDCBA9876543210", "00" * 32,
           "00112233445566778899AABBCCDDEEFF")


def _frames(seed: int, n: int = 3) -> np.ndarray:
    """``n`` random 49-bit AMBE frames, none of them a tone frame."""
    from dsdneo_tpu_torch.vocoder.glue import ambe_tone_info
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        f = rng.integers(0, 2, 49).astype(np.uint8)
        if ambe_tone_info(f) is None:
            out.append(f)
    return np.stack(out)


@pytest.mark.parametrize("key", [0, 1, 7, 128, 255, 256])
def test_dmr_basic_keystream(key):
    assert jks.DMR_BP_KEYS == tks.DMR_BP_KEYS
    np.testing.assert_array_equal(jks.dmr_basic_keystream(key),
                                  tks.dmr_basic_keystream(key))


@pytest.mark.parametrize("klen", [16, 24, 32])
def test_aes_blocks_and_streams(klen):
    rng = np.random.default_rng(klen)
    np.testing.assert_array_equal(jks._aes_sbox(), tks._aes_sbox())
    for _ in range(4):
        key = bytes(rng.integers(0, 256, klen).astype(np.uint8))
        blk = bytes(rng.integers(0, 256, 16).astype(np.uint8))
        assert jks.aes_encrypt_block(blk, key) == tks.aes_encrypt_block(
            blk, key)
        n = int(rng.integers(1, 70))
        np.testing.assert_array_equal(jks.aes_ofb_keystream(key, blk, n),
                                      tks.aes_ofb_keystream(key, blk, n))
        np.testing.assert_array_equal(jks.aes_ctr_keystream(key, blk, n),
                                      tks.aes_ctr_keystream(key, blk, n))
    # the counter wraps at 2^128
    top = b"\xff" * 16
    key = bytes(range(klen))
    np.testing.assert_array_equal(jks.aes_ctr_keystream(key, top, 40),
                                  tks.aes_ctr_keystream(key, top, 40))
    # FIPS-197 C.1 (AES-128)
    if klen == 16:
        assert tks.aes_encrypt_block(
            bytes.fromhex("00112233445566778899aabbccddeeff"),
            bytes(range(16))).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("data", [b"", b"key one", b"x" * 600,
                                  bytes(range(256)) * 3])
def test_md2ii_hash_and_rc2_block(data):
    assert jrc2.md2ii_hash(data) == trc2.md2ii_hash(data)
    rng = np.random.default_rng(len(data))
    xkey = [int(v) for v in rng.integers(0, 1 << 16, 64)]
    for _ in range(4):
        p = bytes(rng.integers(0, 256, 8).astype(np.uint8))
        assert jrc2.rc2_encrypt_block(p, xkey) == trc2.rc2_encrypt_block(
            p, xkey)
    key = bytes(rng.integers(0, 256, 256).astype(np.uint8))
    x64 = int(rng.integers(0, 1 << 62)) << 2 | 3
    a, b = jrc2._Arc4SplitMix(key, x64), trc2._Arc4SplitMix(key, x64)
    assert [a.output() for _ in range(300)] == [b.output()
                                                 for _ in range(300)]


@pytest.mark.parametrize("cls", ["RetevisRC2", "PC4", "PC5"])
@pytest.mark.parametrize("key", KEY_HEX)
def test_frame_ciphers(cls, key):
    jmod, tmod = {"RetevisRC2": (jrc2, trc2), "PC4": (jpc4, tpc4),
                  "PC5": (jpc5, tpc5)}[cls]
    j, t = getattr(jmod, cls).from_hex(key), getattr(tmod, cls).from_hex(key)
    for i, p in enumerate(_frames(len(key) + len(cls), 6)):
        e = t.encrypt_frame49(p)
        np.testing.assert_array_equal(j.encrypt_frame49(p), e)
        np.testing.assert_array_equal(j.decrypt_frame49(e),
                                      t.decrypt_frame49(e))
        np.testing.assert_array_equal(t.decrypt_frame49(e), p)
    for bad in ("123", "zz"):
        with pytest.raises(ValueError):
            getattr(tmod, cls).from_hex(bad)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_vendor_keystreams(seed):
    rng = np.random.default_rng(seed)
    ks = [int(v) for v in rng.integers(0, 1 << 40, 4)]
    np.testing.assert_array_equal(jven.hytera_bp_keystream(*ks),
                                  tven.hytera_bp_keystream(*ks))
    np.testing.assert_array_equal(jven.hytera_bp_keystream(ks[0]),
                                  tven.hytera_bp_keystream(ks[0]))
    k15 = int(rng.integers(1, 1 << 15))
    np.testing.assert_array_equal(jven.kenwood_scrambler_keystream(k15),
                                  tven.kenwood_scrambler_keystream(k15))
    k16 = int(rng.integers(0, 1 << 16))
    np.testing.assert_array_equal(jven.anytone_bp_keystream(k16),
                                  tven.anytone_bp_keystream(k16))
    sf = tven.hytera_bp_keystream(*ks)
    for fr, p in enumerate(_frames(seed, 18)):
        np.testing.assert_array_equal(
            jven.hytera_bp_apply_frame49(sf, fr, p),
            tven.hytera_bp_apply_frame49(sf, fr, p))
    k9 = bytes(rng.integers(0, 256, 9).astype(np.uint8))
    np.testing.assert_array_equal(jven.csi72_keystream72(k9),
                                  tven.csi72_keystream72(k9))
    with pytest.raises(ValueError):
        tven.csi72_keystream72(b"short")
    for fnum in range(20):
        np.testing.assert_array_equal(jven.tyt16_keystream72(k16, fnum),
                                      tven.tyt16_keystream72(k16, fnum))
    user = int(rng.integers(0, 1 << 62)) << 66 | int(rng.integers(0, 1 << 62))
    np.testing.assert_array_equal(jven.tyt_ep_keystream49(user),
                                  tven.tyt_ep_keystream49(user))
    k32 = bytes(rng.integers(0, 256, 32).astype(np.uint8))
    mi = int(rng.integers(0, 1 << 32))
    assert jven.kirisun_adv_keystream(k32, mi) == \
        tven.kirisun_adv_keystream(k32, mi)
    assert jpc4.pc4_kirisun_keystream(k32, mi << 16 | 0xBEEF) == \
        tpc4.pc4_kirisun_keystream(k32, mi << 16 | 0xBEEF)
    spec = f"{int(rng.integers(1, 1 << 32)):X}:{int(rng.integers(8, 33))}"
    js, ts = jven.StaticKeystream.parse(spec), tven.StaticKeystream.parse(
        spec)
    sil = np.array([(jven.AMBE_SILENT_49 >> (48 - i)) & 1
                    for i in range(49)], np.uint8)
    for i, p in enumerate(list(_frames(seed + 10, 5)) + [sil]):
        np.testing.assert_array_equal(js.apply_frame49(p, i % 2),
                                      ts.apply_frame49(p, i % 2))
    assert js.counter == ts.counter


@pytest.mark.parametrize("show", [False, True])
def test_keyring_formatting(show):
    assert jkr.REDACTED == tkr.REDACTED
    rng = np.random.default_rng(5)
    for v in [0, 1, 0x0B57935150] + [int(x) for x in
                                     rng.integers(0, 1 << 40, 5)]:
        for w in (0, 4, 12):
            assert jkr.format_secret_dec(v, show, w) == \
                tkr.format_secret_dec(v, show, w)
            for pre in (False, True):
                assert jkr.format_secret_hex(v, show, w, pre) == \
                    tkr.format_secret_hex(v, show, w, pre)
    j, t = jkr.KeyRing(), tkr.KeyRing()
    for kid, v in ((2, 70), (0xC, 0x0B57935150), (1, 123)):
        j.scalar[kid] = t.scalar[kid] = v
    j.aes[1] = t.aes[1] = bytes(range(16))
    j.aes[4] = t.aes[4] = bytes(range(32))
    assert j.describe(show) == t.describe(show)
    assert (tkr.REDACTED in t.describe(show)) is not show
    for kid in (2, 3, 0xC):
        assert j.lookup(kid) == t.lookup(kid)
    j.forced = t.forced = 0x1234
    assert j.lookup(3) == t.lookup(3) == 0x1234


# -- DmrBsDecoder._synthesize with each cipher -------------------------------
def _cipher_state(name: str, pkg: str):
    """(state attributes, encrypt function) of one cipher for one package:
    the JAX package's objects for "jax", the port's for "torch"."""
    ven, rc2, pc4, pc5, ks = ((jven, jrc2, jpc4, jpc5, jks) if pkg == "jax"
                              else (tven, trc2, tpc4, tpc5, tks))
    if name == "retevis":
        c = rc2.RetevisRC2.from_hex(KEY_HEX[1])
        return {"dmr_retevis_rc2": c}, lambda i, p: c.encrypt_frame49(p)
    if name == "pc4":
        c = pc4.PC4.from_hex(KEY_HEX[3])
        return {"dmr_tyt_ap": c}, lambda i, p: c.encrypt_frame49(p)
    if name == "pc5":
        c = pc5.PC5.from_hex(KEY_HEX[0])
        return {"dmr_baofeng_pc5": c}, lambda i, p: c.encrypt_frame49(p)
    if name == "bp":
        k = ks.dmr_basic_keystream(77)
        return {"dmr_bp_key_id": 77}, lambda i, p: p ^ k
    if name == "tyt_ep":
        k = ven.tyt_ep_keystream49(0x0123456789ABCDEF0011223344556677)
        return ({"dmr_tyt_ep_key": 0x0123456789ABCDEF0011223344556677},
                lambda i, p: p ^ k)
    if name == "hytera":
        sf = ven.hytera_bp_keystream(0x123456789A, 0x1122334455)
        return ({"dmr_hytera_bp": (0x123456789A, 0x1122334455)},
                lambda i, p: ven.hytera_bp_apply_frame49(sf, i % 18, p))
    if name == "kenwood":
        sf = ven.kenwood_scrambler_keystream(12345)
        return ({"dmr_kenwood_key": 12345},
                lambda i, p: ven.hytera_bp_apply_frame49(sf, i % 18, p))
    if name == "anytone":
        sf = ven.anytone_bp_keystream(0x1234)[np.arange(882) % 16]
        return ({"dmr_anytone_key": 0x1234},
                lambda i, p: ven.hytera_bp_apply_frame49(sf, i % 18, p))
    if name == "static":
        enc = ven.StaticKeystream.parse("DEADBEEF:32")
        return ({"dmr_static_ks": ven.StaticKeystream.parse("DEADBEEF:32")},
                lambda i, p: enc.apply_frame49(p))
    if name == "csi72":
        k9 = bytes(range(1, 10))
        return {"dmr_csi72_key": k9}, None
    if name == "tyt16":
        return {"dmr_tyt16_key": 0xABCD}, None
    raise KeyError(name)


_ON_AIR = {          # ciphers of the on-air 72-bit frame: (key, keystream)
    "csi72": lambda fc: jven.csi72_keystream72(bytes(range(1, 10))),
    "tyt16": lambda fc: jven.tyt16_keystream72(0xABCD, fc),
}


CIPHERS = ["retevis", "pc4", "pc5", "bp", "tyt_ep", "hytera", "kenwood",
           "anytone", "static", "csi72", "tyt16"]


@pytest.mark.parametrize("cipher", CIPHERS)
def test_synthesize_with_cipher(cipher):
    """Two voice bursts (six frames) through each package's
    ``_synthesize``: the bits handed to ``decode_ambe_2450`` equal, and
    equal to the clear frames; the PCM within 2e-3 of the peak."""
    plain = _frames(100 + CIPHERS.index(cipher), 6)
    _attrs, enc = _cipher_state(cipher, "jax")
    bursts = []
    for b in range(2):
        fr = []
        for f in range(3):
            i = 3 * b + f
            if enc is None:
                f72 = jaf.encode_ambe_ecc(plain[i]) ^ _ON_AIR[cipher](i)
            else:
                f72 = jaf.encode_ambe_ecc(enc(i, plain[i]))
            fr.append(f72)
        bursts.append(np.concatenate(fr))
    out = {}
    for pkg, base, bs, mbe in (("jax", jbase, jbs, jmbe),
                               ("torch", tbase, tbs, tmbe)):
        attrs, _e = _cipher_state(cipher, pkg)
        ctx = (base.DecoderContext() if pkg == "jax"
               else base.DecoderContext(device="cpu"))
        for k, v in attrs.items():
            setattr(ctx.state, k, v)
        dec = bs.DmrBsDecoder()
        with SV.AmbeSpy(mbe) as spy:
            for v216 in bursts:
                dec._synthesize(v216, 0, ctx)
        out[pkg] = (np.stack(spy.bits), SV.pcm(ctx))
    np.testing.assert_array_equal(out["jax"][0], out["torch"][0])
    np.testing.assert_array_equal(out["torch"][0], plain)
    a, b = out["jax"][1], out["torch"][1]
    assert a.shape == b.shape and a.size == 6 * 160
    assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
