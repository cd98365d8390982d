"""ECDSA P-256 (secp256r1) signatures, pure Python integers.

The port's own copy of ``dsdneo_tpu/crypto/ecdsa.py``: the curve's point
addition and scalar product (``_add``, ``_mul``), ``on_curve``,
``p256_verify_digest`` (a raw 64-byte ``r||s`` signature over a digest
the caller gives, as the reference's
src/crypto/crypt-ecdsa.c dsd_ecdsa_p256_verify_digest takes it),
``p256_sign_digest`` (a deterministic-k signer for the test streams)
and ``p256_public_key``.  The M17 decoder verifies a signed stream with
it, once a stream; no numpy, no torch.
"""

from __future__ import annotations

# NIST P-256 domain parameters
_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
_A = -3
_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
_GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

_INF = None


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p, q):
    if p is _INF:
        return q
    if q is _INF:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % _P == 0:
            return _INF
        lam = (3 * x1 * x1 + _A) * _inv(2 * y1, _P) % _P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    return (x3, (lam * (x1 - x3) - y1) % _P)


def _mul(k: int, p):
    acc = _INF
    while k:
        if k & 1:
            acc = _add(acc, p)
        p = _add(p, p)
        k >>= 1
    return acc


def on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + _A * x + _B)) % _P == 0


def p256_verify_digest(digest: bytes, public_key_xy: bytes,
                       signature_rs: bytes) -> bool:
    """Verify a raw ``r||s`` (64-byte) P-256 signature over ``digest``.

    ``public_key_xy`` is the 64-byte uncompressed point without the
    0x04 prefix, matching the reference's --m17-signature-public-key
    input (src/runtime/cli/args.c:1386-1400)."""
    if len(public_key_xy) != 64 or len(signature_rs) != 64:
        return False
    qx = int.from_bytes(public_key_xy[:32], "big")
    qy = int.from_bytes(public_key_xy[32:], "big")
    if not on_curve(qx, qy):
        return False
    r = int.from_bytes(signature_rs[:32], "big")
    s = int.from_bytes(signature_rs[32:], "big")
    if not (1 <= r < _N and 1 <= s < _N):
        return False
    # FIPS 186-4: e = leftmost n bits of the digest
    e = int.from_bytes(digest, "big")
    if len(digest) * 8 > _N.bit_length():
        e >>= len(digest) * 8 - _N.bit_length()
    w = _inv(s, _N)
    u1 = e * w % _N
    u2 = r * w % _N
    pt = _add(_mul(u1, (_GX, _GY)), _mul(u2, (qx, qy)))
    if pt is _INF:
        return False
    return pt[0] % _N == r


def p256_sign_digest(digest: bytes, private_key: int, k: int) -> bytes:
    """Deterministic-k signing helper (tests only — the decoder never
    signs; the reference's TX side signs via OpenSSL)."""
    e = int.from_bytes(digest, "big")
    if len(digest) * 8 > _N.bit_length():
        e >>= len(digest) * 8 - _N.bit_length()
    pt = _mul(k, (_GX, _GY))
    r = pt[0] % _N
    s = _inv(k, _N) * (e + r * private_key) % _N
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def p256_public_key(private_key: int) -> bytes:
    pt = _mul(private_key, (_GX, _GY))
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
