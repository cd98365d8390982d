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
the JAX package's ``_rs_syndrome_fn``): on a CUDA tensor, or host
words sent to the card, it launches kernel K7 (``csrc/rs_syndromes.cu``,
a GF(2) product on the tensor cores), on a CPU tensor it runs
:func:`rs_syndromes_plain`.

And three Viterbi decoders, each a plain PyTorch loop over time
(:func:`p25_12_decode_plain`, :func:`conv_k5_decode_plain`,
:func:`conv_k3_decode_plain`) and a hand-written kernel behind the entry
point that a CUDA tensor selects: the P25 rate-1/2 trellis
(:func:`p25_12_decode_batch`, kernel K4, ``csrc/p25_trellis.cu``), the
K=5 rate-1/2 weighted soft Viterbi of NXDN and M17
(:func:`conv_k5_decode_batch`, kernel K5, ``csrc/conv_k5.cu``) and the
K=3 hard Viterbi of the D-STAR header (:func:`conv_k3_decode_batch`,
kernel K6, ``csrc/conv_k3.cu``).  All keep the JAX functions' lattices
and tie rules, bit for bit.

And the D-STAR AMBE 3600x2400 voice-frame ECC
(:func:`dstar_ambe_ecc_batch`, the JAX package's ``_dstar_ambe_jit``):
dual Golay(23,12) + PN with D-STAR's row positions, the extended-Golay
parity at ``fr[0][0]`` and the C1 seed from the corrected C0.
"""

from __future__ import annotations

import numpy as np
import torch

from dsdneo_tpu_torch import kernels
from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.fec import conv, trellis
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
_K7_CACHE: dict = {}


def k7_table(n: int, nroots: int, fcr: int) -> np.ndarray:
    """Kernel K7's 0/1 matrix H for words of ``n`` symbols and ``nroots``
    roots from α^fcr, in the order the kernel's lanes read it: uint32
    ``[ceil(nroots / 8), 6, 2, 32, 2]`` (root group q, syndrome bit o,
    k-step s, lane, register).  Row (b, j) of H is bit b of symbol j,
    column (i, o) bit o of S_i; the entry is bit o of α^(b + (n-1-j)(fcr+i))
    (zero for j ≥ n or i ≥ nroots).  A kernel dword M = 2b + h holds rows
    (b, 32h + t) at bit t, M ≥ 12 zero; lane 4g + t of n-tile (q, o) holds
    dwords 8s + t and 8s + 4 + t of column (8q + g, o), the B fragment of
    ``mma.m16n8k256``."""
    exp_t, _log_t = gf64_tables()
    R = -(-nroots // 8) * 8
    b, j, i, o = np.ix_(np.arange(6), np.arange(64), np.arange(R),
                        np.arange(6))
    h = (((exp_t[(b + (n - 1 - j) * (fcr + i)) % 63] >> o) & 1)
         * ((j < n) & (i < nroots))).astype(np.uint32)
    hb = np.zeros((16, R, 6), np.uint32)            # [M, column i, o]
    hb[:12] = (h.reshape(6, 2, 32, R, 6)
               << np.arange(32, dtype=np.uint32)[:, None, None]
               ).sum(axis=2, dtype=np.uint32).reshape(12, R, 6)
    q, o, s, lane, reg = np.ix_(np.arange(R // 8), np.arange(6),
                                np.arange(2), np.arange(32), np.arange(2))
    return np.ascontiguousarray(
        hb[8 * s + 4 * reg + (lane & 3), 8 * q + (lane >> 2), o])


def _k7_tensor(device, n: int, nroots: int, fcr: int) -> torch.Tensor:
    """:func:`k7_table` on ``device``, built once per shape."""
    key = (str(device), n, nroots, fcr)
    if key not in _K7_CACHE:
        _K7_CACHE[key] = torch.as_tensor(k7_table(n, nroots, fcr).view(
            np.int32), device=device)
    return _K7_CACHE[key]


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


def rs_syndromes_batch(words, nroots: int, fcr: int = 1, device=None
                       ) -> torch.Tensor:
    """Batched GF(2^6) syndromes: ``[N, n]`` integer symbols (n ≤ 63) →
    ``[N, nroots]`` int32.  All-zero syndromes ⇒ a clean codeword, which
    skips the host decoder.  GF(64) only: a symbol ≥ 64 (a GF(256) code
    such as DMR's RS(12,9)) raises, as in the JAX package.

    ``words`` is a tensor or host words (a numpy array).  Host words
    have their range checked on the host, then are copied to ``device``
    (the card when none is given), so nothing is read back from the card
    before the launch.  A tensor stays where it lies unless ``device`` is
    given; a CUDA tensor's range is read back from the card.  On the CPU
    the plain version runs, on the card kernel K7."""
    host = not isinstance(words, torch.Tensor)
    if host:
        words = np.asarray(words)
        lo, hi = (int(words.min()), int(words.max())) if words.size else (0, 0)
    else:
        lo, hi = ((int(v) for v in torch.aminmax(words)) if words.numel()
                  else (0, 0))
    if hi >= 64:
        raise ValueError(
            "rs_syndromes_batch covers the GF(2^6) RS-63 family only; "
            f"got symbol {hi} >= 64 (GF(256) codes such as "
            "RS(12,9) need their own field tables)")
    if lo < 0:
        raise ValueError("rs_syndromes_batch: negative symbol")
    if host:
        words = torch.from_numpy(np.ascontiguousarray(words, np.int32))
        if device is None:
            device = require_cuda()
    if device is not None:
        words = words.to(device)
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
    if nroots < 1 or fcr < 0:
        raise ValueError(f"expected nroots >= 1 and fcr >= 0, got "
                         f"{nroots}, {fcr}")
    kernels.require(words, "words", words.dtype, contiguous=False)
    w = words.to(torch.int32).contiguous()
    out = torch.empty((N, nroots), dtype=torch.int32, device=words.device)
    if N == 0:
        return out
    tab = _k7_tensor(words.device, n, nroots, fcr)
    err = kernels.load().dsd_rs_syndromes(
        w.data_ptr(), tab.data_ptr(), out.data_ptr(), N, n, nroots,
        kernels.stream_handle(w))
    kernels.check(err, "rs_syndromes")
    return out


# -- P25 rate-1/2 trellis Viterbi (kernel K4) ---------------------------------
def p25_trellis_consts():
    """(``deperm [196]``, ``expect [4, 4]`` (prev, next) → nibble,
    ``nibbles [16, 4]`` msb-first bits) of the JAX package's
    ``_p25_trellis_consts``, from the port's ``fec.trellis``."""
    il = trellis.interleave_98()
    deperm = np.zeros(196, dtype=np.int32)
    deperm[il * 2] = np.arange(0, 196, 2)
    deperm[il * 2 + 1] = np.arange(1, 196, 2)
    expect = trellis.P25_DTM[(np.arange(4)[:, None] << 2)
                             | np.arange(4)[None, :]].astype(np.int32)
    nibbles = ((np.arange(16)[:, None] >> np.arange(3, -1, -1)[None, :])
               & 1).astype(np.int32)
    return deperm, expect, nibbles


def _hard_llr(bits196: torch.Tensor) -> torch.Tensor:
    """Hard bits → int32 LLRs of ±64 (positive for a 0 bit)."""
    return (1 - 2 * bits196.to(torch.int32)) * 64


def _dibits_to_bits96(states: torch.Tensor) -> torch.Tensor:
    """``[N, 48]`` data dibits → ``[N, 96]`` uint8 bits, high bit first."""
    return torch.stack([(states >> 1) & 1, states & 1], dim=-1
                       ).reshape(states.shape[0], 96).to(torch.uint8)


def p25_12_decode_plain(bits196: torch.Tensor,
                        llr196: torch.Tensor | None = None):
    """The plain PyTorch version of K4: ``[N, 196]`` bits (or int32 LLRs,
    positive for a 0 bit) → (``[N, 96]`` uint8 data bits, ``[N]`` int32
    path costs), the JAX function's 49-step lattice as a loop over the
    steps: four add-compare-selects per step over prev 0..3, replaced
    only by a strictly smaller value; the end state is the first
    minimum; then the traceback."""
    dev = bits196.device
    deperm, expect, nibbles = p25_trellis_consts()
    llr = _hard_llr(bits196) if llr196 is None else llr196
    llr = llr.to(torch.int32)[:, torch.as_tensor(deperm, device=dev,
                                                 dtype=torch.int64)]
    N = llr.shape[0]
    steps = llr.reshape(N, 49, 4)
    pos = torch.clamp(steps, min=0)
    neg = torch.clamp(-steps, min=0)
    nib = torch.as_tensor(nibbles, device=dev)
    cost = (nib[None, None] * pos[:, :, None, :]
            + (1 - nib[None, None]) * neg[:, :, None, :]).sum(
                -1, dtype=torch.int32)                        # [N, 49, 16]
    metric = [torch.full((N,), 0 if k == 0 else 256, dtype=torch.int32,
                         device=dev) for k in range(4)]
    bps = []
    for i in range(49):
        c = cost[:, i]
        news, bp = [], []
        for nxt in range(4):
            best_v = metric[0] + c[:, int(expect[0, nxt])]
            best_i = torch.zeros(N, dtype=torch.int64, device=dev)
            for prev in range(1, 4):
                v = metric[prev] + c[:, int(expect[prev, nxt])]
                take = v < best_v
                best_v = torch.where(take, v, best_v)
                best_i = torch.where(take, prev, best_i)
            news.append(best_v)
            bp.append(best_i)
        metric = news
        bps.append(torch.stack(bp, dim=1))                    # [N, 4]
    best_v = metric[0]
    st = torch.zeros(N, dtype=torch.int64, device=dev)
    for k in range(1, 4):
        take = metric[k] < best_v
        best_v = torch.where(take, metric[k], best_v)
        st = torch.where(take, k, st)
    states = []
    for i in range(48, -1, -1):
        states.append(st)
        st = torch.gather(bps[i], 1, st[:, None])[:, 0]
    data = torch.stack(states[::-1][:48], dim=1)              # [N, 48]
    return _dibits_to_bits96(data), best_v


def _k4_input(bits196: torch.Tensor, llr196: torch.Tensor | None):
    """K4's input as the kernel reads it: (``[N, 196]`` tensor, hard).
    Without LLRs the bits (uint8, or bool viewed as uint8) go in as they
    are and the kernel forms the ±64 LLRs itself; with LLRs, int32.
    Either is contiguous and 16-byte aligned (the kernel stages each
    block's rows in 16-byte pieces), copied only where it is not."""
    hard = llr196 is None
    x = (bits196.view(torch.uint8) if hard else llr196).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, hard


def p25_12_decode_batch(bits196: torch.Tensor,
                        llr196: torch.Tensor | None = None):
    """Batched P25 rate-1/2 trellis decode: ``[N, 196]`` uint8 or bool
    bits (or int32 LLRs ``llr196``) → (``[N, 96]`` uint8 data bits, ``[N]`` int32
    path costs).  A CUDA tensor launches kernel K4 (on the bits
    themselves when no LLRs are given); a CPU tensor runs
    :func:`p25_12_decode_plain`."""
    if bits196.device.type == "cpu":
        return p25_12_decode_plain(bits196, llr196)
    N = bits196.shape[0]
    if bits196.shape[1:] != (196,):
        raise ValueError(f"bits196: expected [N, 196], got "
                         f"{tuple(bits196.shape)}")
    if llr196 is None:
        kernels.require(bits196, "bits196", (torch.uint8, torch.bool),
                        contiguous=False)
    else:
        kernels.require(llr196, "llr196", torch.int32, (N, 196),
                        contiguous=False)
    x, hard = _k4_input(bits196, llr196)
    bits = torch.empty((N, 96), dtype=torch.uint8, device=x.device)
    cost = torch.empty(N, dtype=torch.int32, device=x.device)
    if N:
        err = kernels.load().dsd_p25_trellis(
            x.data_ptr(), int(hard), bits.data_ptr(), cost.data_ptr(), N,
            kernels.stream_handle(x))
        kernels.check(err, "p25_trellis")
        p25_12_decode_batch.launches += 1
    return bits, cost


p25_12_decode_batch.launches = 0


# -- K=5 rate-1/2 convolutional Viterbi (kernel K5) ---------------------------
def conv_k5_decode_plain(sym: torch.Tensor, wt: torch.Tensor
                         ) -> torch.Tensor:
    """The plain PyTorch version of K5: ``[N, 2n]`` float32 soft symbols
    (values in [0, 1]) and weights (0 = punctured) → ``[N, n]`` uint8
    bits, the JAX function's 16-state lattice as a loop over the steps:
    state t from ``t >> 1`` or ``(t >> 1) | 8`` on bit ``t & 1``, the
    second only when strictly cheaper, traceback from state 0."""
    dev = sym.device
    N, n = sym.shape[0], sym.shape[1] // 2
    s = sym.to(torch.float32)
    w = wt.to(torch.float32)
    o1 = conv._O1.astype(np.float32)
    o2 = conv._O2.astype(np.float32)
    metric = [torch.full((N,), 0.0 if t == 0 else 1e30,
                         dtype=torch.float32, device=dev)
              for t in range(16)]
    takes = []
    for i in range(n):
        s0, s1 = s[:, 2 * i], s[:, 2 * i + 1]
        w0, w1 = w[:, 2 * i], w[:, 2 * i + 1]
        news, tk = [], []
        for t in range(16):
            pa, pb, b = t >> 1, (t >> 1) | 8, t & 1
            ca = metric[pa] + (torch.abs(float(o1[pa, b]) - s0) * w0
                               + torch.abs(float(o2[pa, b]) - s1) * w1)
            cb = metric[pb] + (torch.abs(float(o1[pb, b]) - s0) * w0
                               + torch.abs(float(o2[pb, b]) - s1) * w1)
            take_b = cb < ca
            news.append(torch.where(take_b, cb, ca))
            tk.append(take_b)
        metric = news
        takes.append(torch.stack(tk, dim=1))                  # [N, 16]
    bits = []
    st = torch.zeros(N, dtype=torch.int64, device=dev)
    for i in range(n - 1, -1, -1):
        bits.append(st & 1)
        tb = torch.gather(takes[i], 1, st[:, None])[:, 0]
        st = torch.where(tb, (st >> 1) | 8, st >> 1)
    if not bits:
        return torch.zeros((N, 0), dtype=torch.uint8, device=dev)
    return torch.stack(bits[::-1], dim=1).to(torch.uint8)


def _k5_inputs(sym: torch.Tensor, wt: torch.Tensor):
    """K5's inputs as the kernel reads them: (symbols, weights, weight row
    stride in elements).  The symbols contiguous and 8-byte aligned (the
    kernel copies them in 8-byte pairs).  Weights whose row stride is 0
    (an ``expand`` of one row, as the NXDN and M17 paths pass them) stay
    one row, stride 0, which the kernel stages once per block; any other
    layout goes in contiguous, stride 2n.  A tensor is copied only where
    it is not in that form or not aligned."""
    N, n2 = sym.shape
    sym = sym.contiguous()
    if sym.data_ptr() % 8:
        sym = sym.clone()
    if N and wt.stride() == (0, 1):
        row = wt[0]
        return sym, row if row.data_ptr() % 8 == 0 else row.clone(), 0
    wt = wt.contiguous()
    return sym, wt if wt.data_ptr() % 8 == 0 else wt.clone(), n2


def conv_k5_decode_batch(sym: torch.Tensor, wt: torch.Tensor
                         ) -> torch.Tensor:
    """Batched K=5 rate-1/2 Viterbi: ``[N, 2n]`` float32 soft symbols +
    weights (an ``expand`` of one row stays one row) → ``[N, n]`` uint8
    decoded bits (flush bits included; callers slice).  A CUDA tensor
    launches kernel K5; a CPU tensor runs :func:`conv_k5_decode_plain`."""
    if sym.device.type == "cpu":
        return conv_k5_decode_plain(sym, wt)
    N, n2 = sym.shape
    if n2 % 2 or tuple(wt.shape) != (N, n2):
        raise ValueError(f"sym {tuple(sym.shape)} and wt "
                         f"{tuple(wt.shape)}: expected two equal [N, 2n]")
    kernels.require(sym, "sym", torch.float32, contiguous=False)
    kernels.require(wt, "wt", torch.float32, contiguous=False)
    bits = torch.empty((N, n2 // 2), dtype=torch.uint8, device=sym.device)
    if N and n2:
        sym, wt, wt_stride = _k5_inputs(sym, wt)
        err = kernels.load().dsd_conv_k5(
            sym.data_ptr(), wt.data_ptr(), wt_stride, bits.data_ptr(), N,
            n2 // 2, kernels.stream_handle(sym))
        kernels.check(err, "conv_k5")
        conv_k5_decode_batch.launches += 1
    return bits


conv_k5_decode_batch.launches = 0


# -- K=3 rate-1/2 hard Viterbi of the D-STAR header (kernel K6) ---------------
# (pa, a1, a0), (pb, b1, b0) of each new state: its two predecessors and
# the coded pair each would have sent (protocol/dstar/decoder.py _V_TRANS)
K3_TRANS = ((0, 0, 0, 2, 1, 1), (0, 1, 1, 2, 0, 0),
            (1, 1, 0, 3, 0, 1), (1, 0, 1, 3, 1, 0))


def conv_k3_decode_plain(bits: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K6: ``[N, 2n]`` hard bits (pairs
    s1, s0) → ``[N, n]`` uint8 bits, the JAX function's 4-state lattice
    as a loop over the steps: metrics start at 0, each new state takes
    ``pb`` only when strictly cheaper (a tie keeps ``pa = ns >> 1``), the
    end state is the first least metric, and the traceback steps to
    ``(st >> 1) + 2 · took_pb``.  Integer metrics: the JAX function's
    float32 sums of these small integers are exact."""
    dev = bits.device
    N, n = bits.shape[0], bits.shape[1] // 2
    s1 = bits[:, 0::2].to(torch.int32)
    s0 = bits[:, 1::2].to(torch.int32)
    metric = [torch.zeros(N, dtype=torch.int32, device=dev)
              for _ in range(4)]
    takes = []
    for t in range(n):
        a, b = s1[:, t], s0[:, t]
        news, tk = [], []
        for pa, a1, a0, pb, b1, b0 in K3_TRANS:
            ma = metric[pa] + (a - a1).abs() + (b - a0).abs()
            mb = metric[pb] + (a - b1).abs() + (b - b0).abs()
            take_b = mb < ma
            news.append(torch.where(take_b, mb, ma))
            tk.append(take_b)
        metric = news
        takes.append(torch.stack(tk, dim=1))                  # [N, 4]
    st = torch.argmin(torch.stack(metric, dim=1), dim=1)      # first min
    out = []
    for t in range(n - 1, -1, -1):
        out.append(st & 1)
        tb = torch.gather(takes[t], 1, st[:, None])[:, 0]
        st = (st >> 1) + 2 * tb.to(torch.int64)
    if not out:
        return torch.zeros((N, 0), dtype=torch.uint8, device=dev)
    return torch.stack(out[::-1], dim=1).to(torch.uint8)


def conv_k3_decode_batch(bits: torch.Tensor) -> torch.Tensor:
    """Batched K=3 rate-1/2 hard Viterbi (the D-STAR RF header):
    ``[N, 2n]`` uint8 bits → ``[N, n]`` uint8 decoded bits.  A CUDA
    tensor launches kernel K6; a CPU tensor runs
    :func:`conv_k3_decode_plain`."""
    if bits.device.type == "cpu":
        return conv_k3_decode_plain(bits)
    N, n2 = bits.shape
    if n2 % 2:
        raise ValueError(f"bits {tuple(bits.shape)}: expected [N, 2n]")
    kernels.require(bits, "bits", torch.uint8, contiguous=False)
    bits = bits.contiguous()
    out = torch.empty((N, n2 // 2), dtype=torch.uint8, device=bits.device)
    if N and n2:
        err = kernels.load().dsd_conv_k3(
            bits.data_ptr(), out.data_ptr(), N, n2 // 2,
            kernels.stream_handle(bits))
        kernels.check(err, "conv_k3")
        conv_k3_decode_batch.launches += 1
    return out


conv_k3_decode_batch.launches = 0


# -- D-STAR AMBE 3600x2400 voice-frame ECC -----------------------------------
def dstar_ambe_ecc_batch(bits72: torch.Tensor, tables):
    """``[F, 72]`` uint8 on-air bits → (``[F, 49]`` uint8 parameter bits,
    ``[F]`` int32 error counts: the Golay corrections of C0 and C1 plus
    one for an extended-Golay parity mismatch).  ``tables`` is
    ``params.EventTables`` (kind ``dstar``)."""
    x = bits72.to(torch.uint8)
    fr0 = x[:, tables.dstar_r0]                               # [F, 24]
    fr1 = x[:, tables.dstar_r1]                               # [F, 23]
    m0, errs = _ml_dec(fr0[:, 1:24], tables.golay_pm, tables.golay_cb)
    errs = errs + (tables.dstar_parity[m0] != fr0[:, 0]).to(torch.int32)
    m1, e1 = _ml_dec(fr1 ^ tables.dstar_pn[m0], tables.golay_pm,
                     tables.golay_cb)
    out = torch.cat([tables.dstar_param[m0], tables.dstar_param[m1],
                     x[:, tables.dstar_r2], x[:, tables.dstar_r3]], dim=1)
    return out, errs + e1
