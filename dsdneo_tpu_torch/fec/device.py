"""Batched IMBE voice-frame ECC on tensors.

Counterpart of the IMBE part of ``dsdneo_tpu/fec/device.py``
(``_ml_golay_dec``, ``_imbe_ecc_jit.run``, ``imbe_ecc_batch``): the
on-air deinterleave, the Golay(23,12) rows with the PN descramble seeded
by row 0, the Hamming(15,11) rows, and the 7 raw bits of row 7.

Golay and Hamming decode by exact ML: a ±1 codebook correlation as one
float32 matrix product and an argmax (the first maximum, as
``jnp.argmax`` takes it).  Products and sums are small integers, so the
scores are exact and the argmax is the JAX package's, bit for bit.  The
``[F, 4096]`` score tile is taken in row chunks so it stays under
``params.TILE_BYTES``.
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch.params import TILE_BYTES


def _ml_dec(words: torch.Tensor, pm: torch.Tensor, cb: torch.Tensor):
    """``[F, n]`` 0/1 words against a ±1 codebook ``pm [M, n]`` →
    (message index ``[F]`` int64, bit errors ``[F]`` int32)."""
    F, M = words.shape[0], pm.shape[0]
    rows = max(1, TILE_BYTES // (4 * M))
    ms = []
    for r0 in range(0, F, rows):
        s = 1.0 - 2.0 * words[r0:r0 + rows].to(torch.float32)
        ms.append(torch.argmax(s @ pm.T, dim=-1))
    m = torch.cat(ms) if ms else torch.zeros(0, dtype=torch.int64,
                                             device=words.device)
    errs = (cb[m] != words).sum(dim=-1, dtype=torch.int32)
    return m, errs


def imbe_ecc_batch(bits144: torch.Tensor, tables):
    """``[F, 144]`` uint8 on-air bits → (``[F, 88]`` uint8 parameter
    bits, ``[F]`` int32 error counts)."""
    F = bits144.shape[0]
    x = bits144.to(torch.uint8)
    fr = x[:, tables.ecc_gather].reshape(F, 8, 23)
    m0, errs = _ml_dec(fr[:, 0], tables.golay_pm, tables.golay_cb)
    pnb = tables.ecc_pn[tables.ecc_seed_of_msg[m0]]          # [F, 114]
    parts = [tables.ecc_param_g[m0]]
    pos = 0
    for row in range(1, 4):
        w = fr[:, row] ^ pnb[:, pos:pos + 23].flip(-1)
        pos += 23
        m, e = _ml_dec(w, tables.golay_pm, tables.golay_cb)
        errs = errs + e
        parts.append(tables.ecc_param_g[m])
    for row in range(4, 7):
        w = fr[:, row, :15] ^ pnb[:, pos:pos + 15].flip(-1)
        pos += 15
        m, e = _ml_dec(w, tables.h15_pm, tables.h15_cb)
        errs = errs + e
        parts.append(tables.ecc_param_h[m])
    parts.append(fr[:, 7, :7].flip(-1))
    return torch.cat(parts, dim=1), errs
