"""Batched IMBE and AMBE+2 voice-frame ECC on tensors.

Counterpart of the IMBE and AMBE parts of ``dsdneo_tpu/fec/device.py``
(``_ml_golay_dec``, ``_imbe_ecc_jit.run``, ``imbe_ecc_batch``,
``_ambe_ecc_jit.run``, ``ambe_ecc_batch``).  IMBE: the on-air
deinterleave, the Golay(23,12) rows with the PN descramble seeded by row
0, the Hamming(15,11) rows, and the 7 raw bits of row 7.  AMBE+2 (DMR,
NXDN, dPMR, YSF, P25p2, X2-TDMA): the dibit deinterleave, C0 as
Golay(23,12) plus an overall parity bit, C1 as Golay(23,12) descrambled
by the PN row of the corrected C0, and the raw C2 and C3 bits.

Golay and Hamming decode by exact ML: a ±1 codebook correlation as one
float32 matrix product and an argmax (the first maximum, as
``jnp.argmax`` takes it).  Products and sums are small integers, so the
scores are exact and the argmax is the JAX package's, bit for bit.  The
``[F, 4096]`` score tile is taken in row chunks so it stays under
``params.TILE_BYTES``.

Also the GF(64) Reed-Solomon syndrome screen (``rs_syndromes_batch``,
the JAX package's ``_rs_syndrome_fn``): on a CUDA tensor it launches
kernel K7 (``csrc/rs_syndromes.cu``), on a CPU tensor it runs
:func:`rs_syndromes_plain`.
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch import kernels
from dsdneo_tpu_torch.fec.rs import gf64_tables
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


def ambe_ecc_batch(bits72: torch.Tensor, tables):
    """``[F, 72]`` uint8 on-air bits → (``[F, 49]`` uint8 parameter
    bits, ``[F]`` int32 error counts: the Golay corrections of C0 and C1
    plus one for a C0 parity mismatch).  ``tables`` is
    ``params.DmrTables``."""
    F = bits72.shape[0]
    fr = bits72.to(torch.uint8)[:, tables.ambe_gather].reshape(F, 4, 24)
    m0, errs = _ml_dec(fr[:, 0, :23], tables.golay_pm, tables.golay_cb)
    errs = errs + (tables.ambe_parity[m0] != fr[:, 0, 23]).to(torch.int32)
    m1, e1 = _ml_dec(fr[:, 1, :23] ^ tables.ambe_pn[m0], tables.golay_pm,
                     tables.golay_cb)
    out = torch.cat([tables.ambe_param[m0], tables.ambe_param[m1],
                     fr[:, 2, :11], fr[:, 3, :14]], dim=1)
    return out, errs + e1


# -- RS syndrome screen (kernel K7) -------------------------------------------
_GF_CACHE: dict = {}


def _gf_tensors(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The GF(64) exp ``[128]`` and log ``[64]`` tables on ``device``."""
    key = str(device)
    if key not in _GF_CACHE:
        _GF_CACHE[key] = tuple(torch.as_tensor(t, device=device)
                               for t in gf64_tables())
    return _GF_CACHE[key]


def rs_syndromes_plain(words: torch.Tensor, nroots: int, fcr: int = 1
                       ) -> torch.Tensor:
    """The plain PyTorch version: the ``[N, nroots, n]`` exponents, the
    exp table gathered where the symbol is not zero, and the XOR over
    the word taken as six bit planes summed mod 2 (PyTorch has no XOR
    reduction), in row chunks under ``TILE_BYTES``."""
    exp_t, log_t = _gf_tensors(words.device)
    N, n = words.shape
    w = words.to(torch.int64)
    deg = torch.arange(n - 1, -1, -1, device=words.device)
    roots = fcr + torch.arange(nroots, device=words.device)
    bits = torch.arange(6, device=words.device)
    rows = max(1, TILE_BYTES // (8 * 6 * nroots * n))
    out = []
    for r0 in range(0, N, rows):
        wc = w[r0:r0 + rows]
        term = (log_t[wc][:, None, :]
                + deg[None, None, :] * roots[None, :, None]) % 63
        vals = torch.where((wc != 0)[:, None, :], exp_t[term], 0)
        planes = ((vals[..., None] >> bits) & 1).sum(dim=2) & 1
        out.append((planes << bits).sum(dim=-1))
    if not out:
        return torch.zeros((0, nroots), dtype=torch.int32,
                           device=words.device)
    return torch.cat(out).to(torch.int32)


def rs_syndromes_batch(words: torch.Tensor, nroots: int, fcr: int = 1
                       ) -> torch.Tensor:
    """Batched GF(2^6) syndromes: ``[N, n]`` integer symbols (n ≤ 63) →
    ``[N, nroots]`` int32.  All-zero syndromes ⇒ a clean codeword, which
    skips the host decoder.  GF(64) only: a symbol ≥ 64 (a GF(256) code
    such as DMR's RS(12,9)) raises, as in the JAX package; the check
    reads the symbols' range on the host, so a CUDA call waits for the
    card."""
    if words.numel():
        lo, hi = (int(v) for v in torch.aminmax(words))
        if hi >= 64:
            raise ValueError(
                "rs_syndromes_batch covers the GF(2^6) RS-63 family only; "
                f"got symbol {hi} >= 64 (GF(256) codes such as "
                "RS(12,9) need their own field tables)")
        if lo < 0:
            raise ValueError("rs_syndromes_batch: negative symbol")
    if words.device.type == "cpu":
        return rs_syndromes_plain(words, nroots, fcr)
    out = rs_syndromes_launch(words, nroots, fcr)
    rs_syndromes_batch.launches += 1
    return out


rs_syndromes_batch.launches = 0


def rs_syndromes_launch(words: torch.Tensor, nroots: int, fcr: int = 1
                        ) -> torch.Tensor:
    """Kernel K7 on CUDA ``words`` whose symbols lie in [0, 64), without
    the range check of :func:`rs_syndromes_batch` (which is the entry
    point and counts the launches)."""
    N, n = words.shape
    if not 1 <= n <= 63:
        raise ValueError(f"words: expected 1..63 symbols, got {n}")
    kernels.require(words, "words", words.dtype, contiguous=False)
    w = words.to(torch.int32).contiguous()
    exp_t, log_t = _gf_tensors(words.device)
    out = torch.empty((N, nroots), dtype=torch.int32, device=words.device)
    if N == 0:
        return out
    err = kernels.load().dsd_rs_syndromes(
        w.data_ptr(), exp_t.data_ptr(), log_t.data_ptr(), out.data_ptr(),
        N, n, nroots, fcr, kernels.stream_handle(w))
    kernels.check(err, "rs_syndromes")
    return out
