"""Batched IMBE dequantization for the many-channel voice pipeline.

``BatchedImbeDecoder`` decodes whole ``[F, 88]`` blocks of parameter
strings at once, bit-identical to the per-frame
:func:`dsdneo_tpu_torch.vocoder.imbe.decode_frame` (asserted in tests):

- frames are grouped by (L, K); per group the whole transform —
  uniform dequantization, per-block inverse DCTs and the PRBA inverse
  DCT — collapses into ONE cached [L, L] matrix applied by matmul;
- the amplitude bit extraction is a [n_values, n_amp_bits] selection
  matmul against precomputed power-of-two weights;
- inter-frame prediction is vectorized across channels and stepped
  over time (the only sequential axis).

This is what makes the full-chain I/Q→audio benchmark honest: the
per-frame Python dequantizer would dominate a 256-channel step.

The port's own copy of ``dsdneo_tpu/vocoder/batch.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.vocoder import imbe

MAX_L = imbe.MAX_L


@lru_cache(maxsize=None)
def _group_tables(L: int, K: int):
    """Per-(L,K) cached tables: amplitude bit positions, per-value bit
    widths/offsets, dequant scale/offset vectors, and the combined
    [L, 6+(L-6)] inverse-transform matrix."""
    gbits, cbits = imbe.bit_allocation(L, K)
    J = imbe.block_lengths(L)
    pos = imbe._amp_positions(K)
    widths = list(gbits) + [b for blk in cbits for b in blk]
    n_vals = len(widths)

    # bit-selection weight matrix: codes = bits[pos] @ W.T
    W = np.zeros((n_vals, len(pos)), dtype=np.int64)
    cur = 0
    for v, b in enumerate(widths):
        for i in range(b):
            W[v, cur] = 1 << (b - 1 - i)
            cur += 1

    # dequant: x = (code - (2^b-1)/2) * step
    sigmas = ([imbe._sigma_g(m) for m in range(5)]
              + [imbe._sigma_c(k) for blk in cbits for k in range(len(blk))])
    steps = np.array([0.0 if b == 0 else 2.0 * imbe.QUANT_SPAN * s / (1 << b)
                      for b, s in zip(widths, sigmas)])
    offs = np.array([((1 << b) - 1) / 2.0 for b in widths])

    # combined inverse transform: T = A @ [G1..G6, C...] with
    # R = idct6(G) and per-block T_i = idct_Ji([R_i, C_i...])
    def idct_mat(n):
        m = np.zeros((n, n))
        j = np.arange(n)
        m[:, 0] = 1.0
        for q in range(1, n):
            m[:, q] = np.cos(np.pi * q * (j + 0.5) / n)
        return m

    n_coef = 6 + (L - 6)
    A = np.zeros((L, n_coef))
    d6 = idct_mat(6)
    at = 0
    ci = 6
    for i in range(6):
        di = idct_mat(J[i])
        # DC of block i comes from R_i = row i of idct6 applied to G
        A[at:at + J[i], 0:6] = np.outer(di[:, 0], d6[i])
        for k in range(J[i] - 1):
            A[at:at + J[i], ci] = di[:, k + 1]
            ci += 1
        at += J[i]
    return (np.asarray(pos, dtype=np.int64), W, steps, offs, A)


def _extract_header(S: np.ndarray):
    """[F, 88] → (gain_code, b0) vectorized."""
    gshift = np.array([5 - i for i in range(6)])
    gain = (S[:, imbe.GAIN_POS].astype(np.int64) << gshift).sum(axis=1)
    bshift = np.array([7 - i for i in range(6)])
    b0 = (S[:, imbe.B0_HI_POS].astype(np.int64) << bshift).sum(axis=1)
    b0 |= (S[:, imbe.B0_LO_POS[0]].astype(np.int64) << 1)
    b0 |= S[:, imbe.B0_LO_POS[1]].astype(np.int64)
    return gain, b0


class BatchedImbeDecoder:
    """Per-channel prediction state + block decode.

    ``step(S, active)`` decodes one frame per channel: S [C, 88],
    active [C] bool (inactive channels keep their state untouched and
    emit zeros).  Returns (w0 [C], L [C], voiced [C, MAX_L],
    amps [C, MAX_L]) with padding zeroed.
    """

    def __init__(self, C: int):
        self.C = C
        self.prev_logm = np.zeros((C, MAX_L))
        self.prev_L = np.zeros(C, dtype=np.int64)

    def step(self, S: np.ndarray, active: np.ndarray | None = None):
        C = self.C
        if active is None:
            active = np.ones(C, dtype=bool)
        w0o = np.zeros(C)
        Lo = np.zeros(C, dtype=np.int64)
        voiced = np.zeros((C, MAX_L), dtype=np.float32)
        amps = np.zeros((C, MAX_L), dtype=np.float32)
        idx_act = np.flatnonzero(active)
        if idx_act.size == 0:
            return w0o, Lo, voiced, amps

        gain, b0 = _extract_header(S[idx_act])
        # vectorized (w0, L, K)
        b0c = np.clip(b0, 0, 207)
        w0 = 4.0 * np.pi / (b0c + 39.5)
        L = (0.9254 * ((np.pi / w0) + 0.25).astype(np.int64)).astype(np.int64)
        L = np.clip(L, 9, MAX_L)
        K = np.minimum((L + 2) // 3, 12)

        # prediction input: resample prev log_m to the new L (vectorized)
        lidx = np.arange(1, MAX_L + 1)[None, :]                 # [1, MAX_L]
        pl = self.prev_L[idx_act][:, None]
        k = np.where(pl > 0, lidx * pl / np.maximum(L[:, None], 1), 1.0) - 1.0
        k0 = np.clip(np.floor(k).astype(np.int64), 0, np.maximum(pl - 1, 0))
        k1 = np.minimum(k0 + 1, np.maximum(pl - 1, 0))
        frac = np.clip(k - k0, 0.0, 1.0)
        src = self.prev_logm[idx_act]
        g0 = np.take_along_axis(src, k0, axis=1)
        g1 = np.take_along_axis(src, k1, axis=1)
        pred_full = (1 - frac) * g0 + frac * g1                 # [n, MAX_L]

        T_full = np.zeros((idx_act.size, MAX_L))
        for (Lg, Kg) in {(int(a), int(b)) for a, b in zip(L, K)}:
            sel = np.flatnonzero((L == Lg) & (K == Kg))
            pos, W, steps, offs, A = _group_tables(Lg, Kg)
            bits = S[idx_act[sel]][:, pos].astype(np.int64)     # [n, nbits]
            codes = bits @ W.T                                  # [n, n_vals]
            x = (codes - offs) * steps
            G1 = imbe.GAIN_MIN + gain[sel] * imbe.GAIN_STEP
            coef = np.concatenate([G1[:, None], x], axis=1)     # [n, 6+L-6]
            T_full[sel, :Lg] = coef @ A.T

        # mean-removed prediction over the valid L range
        n = idx_act.size
        mask = lidx <= L[:, None]                               # [n, MAX_L]
        pvalid = np.where(mask, pred_full, 0.0)
        pmean = pvalid.sum(axis=1) / L
        pred = imbe.PRED_DECAY * (pvalid - pmean[:, None]) * mask
        has_prev = (self.prev_L[idx_act] > 0)[:, None]
        logm = T_full + np.where(has_prev, pred, 0.0)
        logm *= mask

        # voicing: band ceil(l/3) clamped to K, band-1-first at S[48..]
        band = np.minimum((lidx - 1) // 3, (K - 1)[:, None])    # [n, MAX_L]
        vbits = S[idx_act][:, imbe.VOICING_START:imbe.VOICING_START + 12]
        v = np.take_along_axis(
            np.asarray(vbits, dtype=np.float32), band, axis=1) * mask

        self.prev_logm[idx_act] = logm
        self.prev_L[idx_act] = L

        w0o[idx_act] = w0
        Lo[idx_act] = L
        voiced[idx_act] = v.astype(np.float32)
        from dsdneo_tpu_torch.vocoder.mbe import _IMBE_AMP_SCALE
        amps[idx_act] = (np.exp2(np.clip(logm, -4.0, 14.0)) * mask
                         * _IMBE_AMP_SCALE).astype(np.float32)
        return w0o, Lo, voiced, amps


def decode_transforms(S_all: np.ndarray):
    """Pass 1 (fully vectorized over ALL frames): extract headers and
    apply the per-(L,K) amplitude transforms → (T_full [F, MAX_L],
    w0 [F], L [F], K [F]).  Prediction is NOT applied here — pass 2
    (:func:`run_prediction`) handles the sequential part."""
    F = S_all.shape[0]
    gain, b0 = _extract_header(S_all)
    b0c = np.clip(b0, 0, 207)
    w0 = 4.0 * np.pi / (b0c + 39.5)
    L = (0.9254 * ((np.pi / w0) + 0.25).astype(np.int64)).astype(np.int64)
    L = np.clip(L, 9, MAX_L)
    K = np.minimum((L + 2) // 3, 12)
    T_full = np.zeros((F, MAX_L))
    for (Lg, Kg) in {(int(a), int(b)) for a, b in zip(L, K)}:
        sel = np.flatnonzero((L == Lg) & (K == Kg))
        pos, W, steps, offs, A = _group_tables(Lg, Kg)
        bits = S_all[sel][:, pos].astype(np.int64)
        codes = bits @ W.T
        x = (codes - offs) * steps
        G1 = imbe.GAIN_MIN + gain[sel] * imbe.GAIN_STEP
        coef = np.concatenate([G1[:, None], x], axis=1)
        T_full[sel, :Lg] = coef @ A.T
    return T_full, w0, L, K


def run_prediction(dec: "BatchedImbeDecoder", T: np.ndarray,
                   w0: np.ndarray, L: np.ndarray, K: np.ndarray,
                   S_all: np.ndarray, active: np.ndarray):
    """Pass 2: the sequential inter-frame prediction recurrence for ONE
    time step across all channels (cheap [C, MAX_L] numpy ops), exactly
    matching BatchedImbeDecoder.step()."""
    C = dec.C
    w0o = np.zeros(C)
    Lo = np.zeros(C, dtype=np.int64)
    voiced = np.zeros((C, MAX_L), dtype=np.float32)
    amps = np.zeros((C, MAX_L), dtype=np.float32)
    idx = np.flatnonzero(active)
    if idx.size == 0:
        return w0o, Lo, voiced, amps
    lidx = np.arange(1, MAX_L + 1)[None, :]
    pl = dec.prev_L[idx][:, None]
    k = np.where(pl > 0, lidx * pl / np.maximum(L[idx][:, None], 1), 1.0) - 1.0
    k0 = np.clip(np.floor(k).astype(np.int64), 0, np.maximum(pl - 1, 0))
    k1 = np.minimum(k0 + 1, np.maximum(pl - 1, 0))
    frac = np.clip(k - k0, 0.0, 1.0)
    src = dec.prev_logm[idx]
    pred_full = (1 - frac) * np.take_along_axis(src, k0, axis=1) \
        + frac * np.take_along_axis(src, k1, axis=1)
    mask = lidx <= L[idx][:, None]
    pvalid = np.where(mask, pred_full, 0.0)
    pmean = pvalid.sum(axis=1) / L[idx]
    pred = imbe.PRED_DECAY * (pvalid - pmean[:, None]) * mask
    has_prev = (dec.prev_L[idx] > 0)[:, None]
    logm = (T[idx] + np.where(has_prev, pred, 0.0)) * mask

    band = np.minimum((lidx - 1) // 3, (K[idx] - 1)[:, None])
    vbits = S_all[idx][:, imbe.VOICING_START:imbe.VOICING_START + 12]
    v = np.take_along_axis(np.asarray(vbits, np.float32), band, axis=1) * mask

    dec.prev_logm[idx] = logm
    dec.prev_L[idx] = L[idx]
    w0o[idx] = w0[idx]
    Lo[idx] = L[idx]
    voiced[idx] = v.astype(np.float32)
    from dsdneo_tpu_torch.vocoder.mbe import _IMBE_AMP_SCALE
    amps[idx] = (np.exp2(np.clip(logm, -4.0, 14.0)) * mask
                 * _IMBE_AMP_SCALE).astype(np.float32)
    return w0o, Lo, voiced, amps
