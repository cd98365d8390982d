"""The plain P25 Phase 1 C4FM voice chain the benchmark holds the port to.

A frozen copy of the port's plain paths as they stood at commit
1acf1f855b4962341c6932295300c03c25b32489 (``dsdneo_tpu_torch``), so a
later change to the port cannot move the yardstick.  It imports nothing
of the port: its tables come from ``portbench/data/p25p1_tables.npz``
(a copy of the port's tables file at that commit), the BCH(63,16) NID
codebook is expanded here from its generator polynomial.

Copied from, function by function:

- ``dsp/frontend.py``: ``_fir_real``, ``fir_complex``,
  ``fm_discriminate``, ``floor_mod`` (kernel K1's plain version is
  ``fm_discriminate(fir_complex(x, taps))``);
- ``engine/batched.py``: ``frontend_step``, ``symbolize_step``,
  ``slice_four_level``;
- ``engine/voicebatch.py``: ``correlate_syncs_device``,
  ``_ldu_imbe_offsets``, ``_status_strip_map``, and of
  ``BatchedP25VoicePipeline`` ``_nid_msgs``, ``_bch_msgs``,
  ``frontend_dispatch``, ``frontend_finish``, ``_peak_hits``,
  ``nid_decode_positions``, ``pick_frames_by_duid``, ``pick_ldus`` and
  ``decode_from_frontend``;
- ``params.py``: ``bch_63_16_codebook``, ``_synth_tensors`` and the
  tensors of ``P25Tables``;
- ``fec/device.py``: ``_ml_dec``, ``imbe_ecc_batch``;
- ``vocoder/device.py``: ``_weights``, ``_headers``,
  ``_per_frame_matvec``, ``_transforms``, ``prediction_scan_plain``
  (kernel K2's plain version), ``_b0_code``, ``imbe_frame_good``,
  ``imbe_tone_params``, ``repeat_state_init``, ``synth_state_init``,
  ``repeat_gate``, ``noise_phases``, ``_scatter``,
  ``prediction_inputs``, ``_decode_from_frames``, ``voice_decode_gather``;
- ``vocoder/synth.py``: ``blocked_cumsum``, ``tree_sum``, ``fma_f32``,
  ``_phase``, ``_synth_chunk``, ``synthesize_stream``;
- ``ops/audio_wire.py``: ``scale_clip``, ``adpcm_compress_plain``
  (kernel K3's plain version, here in NumPy on the host) and
  ``adpcm_expand_np`` (the host decoder's plain version).

One thing is added: ``tf32``.  With it every matrix product and the
channel FIR round their inputs to TF32 (10 mantissa bits), as the
card's tensor cores do with ``allow_tf32``: the precision below the
configuration's float32, which is the control that has to fail.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

DATA_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "p25p1_tables.npz")
MAX_L = 56
L_MIN = 9
N_BINS = 79
TILE_BYTES = 256 << 20
BCH_63_16_GEN = 0xCD930BDD3B2B
SYNC_TOPK = 512
NID_TOPK = 48
N_BANDS = 12
MAX_REPEAT = 3
TONE_FREQ_STEP_HZ = 31.25
TONE_AMP_STEP = 75.0
PCM_SCALE = 0.02
N = 160
SCAN_BLOCK = 16
TREE_WINDOW = 32
LDU_DATA_DIBITS = 784
# a dibit whose soft symbol lies this close to a slicer threshold (0, ±2)
# may be sliced either way by two sound float32 front ends, and such a
# flip in a voice frame changes its ECC error count or its 7 uncoded
# bits; set from the largest gap between the program's soft symbols and
# this chain's on the cells' inputs, measured on the card (PERF.md §2)
MARGINAL = 3e-5


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as a float32 tensor."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


# -- tables ------------------------------------------------------------------
def read_npz(path: str = DATA_NPZ) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_vector(path: str = DATA_NPZ) -> dict[str, np.ndarray]:
    """The frozen test vector: ``body``, ``lead``, ``tail``,
    ``ldu_starts``, ``bits88`` (the ``tv_`` arrays)."""
    return {k[3:]: v for k, v in read_npz(path).items()
            if k.startswith("tv_")}


def _poly_mod(a: int, m: int) -> int:
    dm = m.bit_length() - 1
    while a.bit_length() - 1 >= dm:
        a ^= m << (a.bit_length() - 1 - dm)
    return a


@lru_cache(maxsize=1)
def bch_63_16_codebook() -> np.ndarray:
    """All 2^16 codewords of the systematic BCH(63,16) NID code,
    ``[65536, 63]`` uint8."""
    n, k = 63, 16
    nk = n - k
    basis = np.zeros((k, nk), dtype=np.uint8)
    for i in range(k):
        rem = _poly_mod(1 << (k - 1 - i + nk), BCH_63_16_GEN)
        basis[i] = [(rem >> (nk - 1 - j)) & 1 for j in range(nk)]
    msgs = ((np.arange(1 << k, dtype=np.uint32)[:, None]
             >> np.arange(k - 1, -1, -1, dtype=np.uint32)[None, :]) & 1
            ).astype(np.uint8)
    parity = (msgs @ basis) & 1
    return np.concatenate([msgs, parity], axis=1)


def load_tables(device, path: str = DATA_NPZ) -> SimpleNamespace:
    """The P25 voice path's constants as tensors on ``device`` (the
    port's ``P25Tables``, the attributes this chain reads)."""
    t = read_npz(path)
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    u8 = lambda a: torch.as_tensor(np.asarray(a, np.uint8), device=dev)
    kk = np.arange(N_BINS)
    ns = SimpleNamespace(
        np=t,
        taps=f32(t["taps"]), symbol_rate=float(t["symbol_rate"]),
        four_level=bool(t["four_level"]), sync_levels=f32(t["sync_levels"]),
        sync_inverted=tuple(bool(x) for x in t["sync_inverted"]),
        sync_len=int(t["sync_levels"].shape[1]),
        golay_cb=u8(t["golay_codebook"]),
        golay_pm=f32(1.0 - 2.0 * t["golay_codebook"]),
        adpcm_step=t["adpcm_step"].astype(np.int32),
        adpcm_index=t["adpcm_index"].astype(np.int32),
        synth_bin_w=f32(t["synth_bin_w"]),
        synth_bin_cos=f32(t["synth_bin_cos"]),
        synth_bin_sin=f32(t["synth_bin_sin"]),
        synth_phi_off=f32((2.399963 * (kk // MAX_L) * (kk + 3)
                           ).astype(np.float32)),
        synth_bin_l=torch.as_tensor(kk % MAX_L, dtype=torch.int64,
                                    device=dev),
        bch_pm=f32(1.0 - 2.0 * bch_63_16_codebook()),
        ecc_gather=i64(t["ecc_gather"].reshape(-1)),
        ecc_pn=u8(t["ecc_pn"]), ecc_seed_of_msg=i64(t["ecc_seed_of_msg"]),
        ecc_param_g=u8(t["ecc_param_g"]), ecc_param_h=u8(t["ecc_param_h"]),
        h15_cb=u8(t["h15_codebook"]),
        h15_pm=f32(1.0 - 2.0 * t["h15_codebook"]),
        dq_pos=i64(t["dq_pos"]), dq_w=f32(t["dq_w"]),
        dq_steps=f32(t["dq_steps"]), dq_offs=f32(t["dq_offs"]),
        dq_a=f32(t["dq_a"]), gain_pos=i64(t["gain_pos"]),
        b0_hi_pos=i64(t["b0_hi_pos"]),
        b0_lo_pos=tuple(int(x) for x in t["b0_lo_pos"]),
        voicing_start=int(t["voicing_start"]),
        gain_min=float(t["gain_min"]), gain_step=float(t["gain_step"]),
        pred_decay=float(t["pred_decay"]),
        imbe_amp_scale=float(t["imbe_amp_scale"]),
        tone_b0_min=int(t["tone_b0_min"]),
        tone_b0_max=int(t["tone_b0_max"]))
    return ns


# -- small helpers -----------------------------------------------------------
def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def fma_f32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    xp = F.pad(x, (0, nb * SCAN_BLOCK - n))
    inner = blocked_cumsum(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    outer = blocked_cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                     dim=-1)
    return (inner + excl[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= TREE_WINDOW:
        return _sequential_sum(x)
    p = -(-n // TREE_WINDOW) * TREE_WINDOW
    lo = (p - n) // 2
    xp = F.pad(x, (lo, p - n - lo))
    return tree_sum(_sequential_sum(
        xp.reshape(*x.shape[:-1], p // TREE_WINDOW, TREE_WINDOW)))


def _ldu_imbe_offsets() -> list[int]:
    offs, at = [], 0
    for seg in range(9):
        offs.append(at)
        at += 72
        if 1 <= seg <= 6:
            at += 20
        elif seg == 7:
            at += 16
    return offs


LDU_IMBE_OFFSETS = _ldu_imbe_offsets()


@lru_cache(maxsize=None)
def _status_strip_map(rel_start: int, count: int) -> np.ndarray:
    out = np.zeros(count, dtype=np.int64)
    q = rel_start
    for i in range(count):
        while q % 36 == 35:
            q += 1
        out[i] = q
        q += 1
    return out


def _weights(n: int, device) -> torch.Tensor:
    return torch.tensor([1 << (n - 1 - i) for i in range(n)],
                        dtype=torch.int64, device=device)


# -- ADPCM (host) ------------------------------------------------------------
def adpcm_compress_np(pcm: np.ndarray, step_table: np.ndarray,
                      index_table: np.ndarray) -> np.ndarray:
    """IMA ADPCM encode ``[S, T]`` float32 in [-1, 1] → ``[S, T//2]``
    uint8; every stream starts from (predictor 0, index 0)."""
    S, T = pcm.shape
    x = np.round(pcm.astype(np.float32) * np.float32(32767.0)
                 ).astype(np.int32)
    steps = step_table.astype(np.int32)
    itab = index_table.astype(np.int32)
    pred = np.zeros(S, np.int32)
    idx = np.zeros(S, np.int32)
    codes = np.empty((S, T), np.int32)
    for t in range(T):
        step = steps[idx]
        diff = x[:, t] - pred
        sign = diff < 0
        ad = np.abs(diff)
        b2 = ad >= step
        ad = ad - b2 * step
        h1 = step >> 1
        b1 = ad >= h1
        ad = ad - b1 * h1
        h2 = step >> 2
        b0 = ad >= h2
        vpdiff = (step >> 3) + b2 * step + b1 * h1 + b0 * h2
        pred = np.clip(pred + np.where(sign, -vpdiff, vpdiff), -32768, 32767)
        code = (sign.astype(np.int32) << 3) | (b2.astype(np.int32) << 2) \
            | (b1.astype(np.int32) << 1) | b0.astype(np.int32)
        idx = np.clip(idx + itab[code], 0, 88)
        codes[:, t] = code
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def adpcm_expand_np(blob: np.ndarray, step_table: np.ndarray,
                    index_table: np.ndarray) -> np.ndarray:
    S, T2 = blob.shape
    codes = np.zeros((S, 2 * T2), dtype=np.int32)
    codes[:, 0::2] = blob & 0xF
    codes[:, 1::2] = blob >> 4
    pred = np.zeros(S, np.int32)
    idx = np.zeros(S, np.int32)
    out = np.empty((S, 2 * T2), dtype=np.float32)
    for t in range(2 * T2):
        c = codes[:, t]
        step = step_table[idx]
        vpdiff = ((step >> 3) + np.where(c & 4, step, 0)
                  + np.where(c & 2, step >> 1, 0)
                  + np.where(c & 1, step >> 2, 0))
        pred = np.clip(pred + np.where(c & 8, -vpdiff, vpdiff),
                       -32768, 32767)
        idx = np.clip(idx + index_table[c], 0, 88)
        out[:, t] = pred
    return out / np.float32(32767.0)


class P25Chain:
    """The plain chain over ``[C, B, 2]`` float32 I/Q blocks on
    ``device``, one block at a time from a given carry; ``tf32`` rounds
    the inputs of every product and of the channel FIR to TF32."""

    def __init__(self, C: int, fs: float = 48000.0, device="cpu",
                 tables=None, tf32: bool = False,
                 sync_threshold: float = 0.62):
        self.device = torch.device(device)
        self.tables = tables if tables is not None else load_tables(device)
        self.C = C
        self.fs = fs
        self.sps = fs / self.tables.symbol_rate
        self.threshold = sync_threshold
        self.tf32 = tf32
        n_pat = self.tables.sync_len
        self._nid_strip = torch.as_tensor(_status_strip_map(n_pat, 32),
                                          device=self.device)
        strip = _status_strip_map(n_pat, 32 + LDU_DATA_DIBITS)
        self._ldu_need = int(strip[-1]) + 1
        self._frame_offs = torch.as_tensor(np.stack(
            [strip[32 + o:32 + o + 72] for o in LDU_IMBE_OFFSETS]),
            device=self.device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return torch.matmul(a, b)

    # -- front end -----------------------------------------------------------
    def _fir_real(self, x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
        t = taps.shape[0]
        left = (t - 1) // 2
        xp = F.pad(x[:, None, :], (left, t - 1 - left))
        w = taps.flip(0).to(x.dtype)[None, None, :]
        if self.tf32:
            xp, w = to_tf32(xp), to_tf32(w)
        tf = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv1d(xp, w)[:, 0, :]
        finally:
            torch.backends.cudnn.allow_tf32 = tf

    def fir_complex(self, x: torch.Tensor, taps: torch.Tensor):
        return torch.complex(self._fir_real(x.real.contiguous(), taps),
                             self._fir_real(x.imag.contiguous(), taps))

    @staticmethod
    def fm_discriminate(x: torch.Tensor) -> torch.Tensor:
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        p = x * prev.conj()
        return torch.atan2(p.imag, p.real) * (1.0 / math.pi)

    def frontend_step(self, iq, taps, sps, n_sym, four_level=True):
        xr = iq[..., 0]
        xi = iq[..., 1]
        d = self.fm_discriminate(self.fir_complex(torch.complex(xr, xi),
                                                  taps))
        dibits, norm = self.symbolize_step(d, sps, n_sym, four_level)
        power = torch.mean(xr * xr + xi * xi, dim=-1)
        return dibits, norm, power

    def symbolize_step(self, d, sps, n_sym, four_level=True):
        c, n = d.shape
        dev = d.device
        dc = torch.mean(d, dim=-1, keepdim=True)
        e = (d - dc) ** 2
        idx = torch.arange(n, dtype=torch.float32, device=dev)
        ang = (2.0 * math.pi / sps) * idx
        wlen = min(2048, n)
        nww = n // wlen
        ec = e[:, :nww * wlen].reshape(c, nww, wlen)
        cr = torch.cos(ang[:nww * wlen]).reshape(nww, wlen)
        ci = torch.sin(ang[:nww * wlen]).reshape(nww, wlen)
        Xr = torch.sum(ec * cr[None], dim=-1)
        Xi = -torch.sum(ec * ci[None], dim=-1)
        w = 1.0 / (torch.sum(ec, dim=-1) + 1e-9)
        Xre = torch.sum(Xr * w, dim=-1)
        Xim = torch.sum(Xi * w, dim=-1)
        tau = floor_mod(-torch.atan2(Xim, Xre) * (sps / (2 * math.pi)), sps)

        isps = int(round(sps))
        if abs(sps - isps) < 1e-9 and n_sym * isps + isps <= n:
            o = torch.floor(tau).to(torch.int32)
            frac = (tau - o.to(torch.float32))[:, None]
            dr = d[:, :n_sym * isps].reshape(c, n_sym, isps)
            nxt = d[:, isps:n_sym * isps + isps:isps]
            dr = torch.cat([dr, nxt[:, :, None]], dim=2)
            j = torch.arange(isps + 1, dtype=torch.int32, device=dev)[None, :]
            oc = o[:, None]
            wts = (torch.where(j == oc, 1.0 - frac, 0.0)
                   + torch.where(j == oc + 1, frac, 0.0))
            sym = torch.einsum("ckj,cj->ck", dr, wts)
        else:
            k = torch.arange(n_sym, dtype=torch.float32, device=dev)
            pos = k[None, :] * sps + tau[:, None]
            pos = torch.clamp(pos, 0.0, n - 2.0)
            i0 = torch.floor(pos).to(torch.int64)
            frac = pos - i0.to(torch.float32)
            g0 = torch.gather(d, 1, i0)
            g1 = torch.gather(d, 1, i0 + 1)
            sym = g0 * (1.0 - frac) + g1 * frac

        win = min(256, n_sym)
        nw = max(n_sym // win, 1)
        body = sym[:, :nw * win].reshape(c, nw, win)
        hi = torch.amax(body, dim=-1)
        lo = torch.amin(body, dim=-1)
        center = torch.repeat_interleave((hi + lo) * 0.5, win, dim=-1)
        swing = torch.clamp((hi - lo) * 0.5, min=1e-6)
        scale = torch.repeat_interleave(
            torch.where(swing < 1e-5, torch.full_like(swing, math.inf),
                        swing), win, dim=-1)
        pad = n_sym - nw * win
        if pad > 0:
            center = torch.cat([center, center[:, -1:].expand(c, pad)],
                               dim=-1)
            scale = torch.cat([scale, scale[:, -1:].expand(c, pad)], dim=-1)
        norm = (sym - center) / scale * 3.0
        if four_level:
            return self.slice_four_level(norm), norm
        return torch.where(norm < 0.0, 3, 1).to(torch.uint8), norm

    @staticmethod
    def slice_four_level(soft: torch.Tensor) -> torch.Tensor:
        neg = soft < 0.0
        outer = soft.abs() > 2.0
        return torch.where(neg, torch.where(outer, 3, 2),
                           torch.where(outer, 1, 0)).to(torch.uint8)

    @staticmethod
    def correlate_syncs(soft, levels):
        P, n = levels.shape
        Tp = soft.shape[1] - n + 1
        acc = soft[:, None, 0:Tp] * levels[None, :, 0, None]
        for i in range(1, n):
            acc = acc + soft[:, None, i:i + Tp] * levels[None, :, i, None]
        return acc * torch.tensor(1.0 / (9.0 * n), dtype=torch.float32,
                                  device=soft.device)

    def _nid_msgs(self, dibits, ch, pos):
        Tn = dibits.shape[1]
        gp = torch.clamp(pos[:, None] + self._nid_strip, 0, Tn - 1)
        nd = dibits[ch[:, None], gp]
        b64 = torch.stack([(nd >> 1) & 1, nd & 1], dim=-1
                          ).reshape(nd.shape[0], 64)
        return self._bch_msgs(b64[:, :63])

    def _bch_msgs(self, bits63):
        s = 1.0 - 2.0 * bits63.to(torch.float32)
        pm_t = self.tables.bch_pm.T
        rows = max(1, TILE_BYTES // (4 * pm_t.shape[1]))
        out = [torch.argmax(self.mm(s[r:r + rows], pm_t), dim=-1)
               for r in range(0, s.shape[0], rows)]
        if not out:
            return torch.zeros(0, dtype=torch.int32, device=bits63.device)
        return torch.cat(out).to(torch.int32)

    def frontend(self, iq):
        """Front end, sync filter and NID decode of one block; the
        candidates copied to the host, the dibits and soft symbols left on
        the device."""
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        B = x.shape[1]
        n_sym = int(B // self.sps) - 2
        t = self.tables
        dibits, soft, _power = self.frontend_step(x, t.taps, self.sps, n_sym,
                                                  t.four_level)
        sc = self.correlate_syncs(soft, t.sync_levels)
        best_def = torch.argmax(sc, dim=1).to(torch.uint8)
        bs = torch.amax(sc, dim=1)
        k_cand = min(SYNC_TOPK, n_sym - t.sync_len + 1)
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k_cand], idx[:, :k_cand]
        vq = torch.clamp(vals * 127.0, 0, 255).to(torch.uint8)
        dq = torch.gather(best_def, 1, idx)
        k_nid = min(NID_TOPK, k_cand)
        C = dibits.shape[0]
        rows = torch.arange(C, device=self.device)[:, None].expand(C, k_nid)
        msg = self._nid_msgs(dibits, rows.reshape(-1),
                             idx[:, :k_nid].reshape(-1)).reshape(C, k_nid)
        return (dibits, idx.cpu().numpy().astype(np.int64),
                vq.cpu().numpy(), dq.cpu().numpy(),
                msg.cpu().numpy().astype(np.int32), n_sym, soft)

    # -- host LDU picker -----------------------------------------------------
    def _peak_hits(self, idx, vq, dq):
        plen = self.tables.sync_len
        hits = []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            positions = idx[c][ok]
            order = np.argsort(positions, kind="stable")
            positions = positions[order].tolist()
            scores = sc[ok][order].tolist()
            pdefs = dq[c][ok][order].tolist()
            pos = 0
            n = len(positions)
            for j in range(n):
                t = positions[j]
                if t < pos:
                    continue
                w = j
                for j2 in range(j + 1, n):
                    if positions[j2] >= t + 8:
                        break
                    if scores[j2] > scores[w]:
                        w = j2
                p = positions[w]
                pos = p + plen
                hits.append((c, p, pdefs[w]))
        return hits

    def nid_decode_positions(self, dibits_dev, ch, pos):
        H = ch.shape[0]
        if H == 0:
            return np.zeros(0, dtype=np.int32)
        chv = torch.clamp(torch.as_tensor(ch.astype(np.int64),
                                          device=self.device),
                          max=dibits_dev.shape[0] - 1)
        posv = torch.as_tensor(pos.astype(np.int64), device=self.device)
        return self._nid_msgs(dibits_dev, chv, posv).cpu().numpy()

    def pick_ldus(self, idx, vq, dq, msg, T, dibits_dev=None):
        """Accept LDU1/LDU2 (DUID 5/10) hits outside any previous LDU →
        (channel [L], sync position [L], frame channel [9L], frame step
        [9L])."""
        inverted = self.tables.sync_inverted
        need = self._ldu_need
        k_nid = msg.shape[1]
        hits = self._peak_hits(idx, vq, dq)
        hmsg = []
        if hits:
            kk = min(k_nid, idx.shape[1])
            Tbig = int(idx.max()) + 2 if idx.size else 1
            keys = (np.arange(idx.shape[0], dtype=np.int64)[:, None]
                    * Tbig + idx[:, :kk]).ravel()
            vals = msg[:, :kk].ravel()
            srt = np.argsort(keys, kind="stable")
            keys_s, vals_s = keys[srt], vals[srt]
            hk = np.asarray([h[0] * Tbig + h[1] for h in hits],
                            dtype=np.int64)
            ji = np.clip(np.searchsorted(keys_s, hk), 0, len(keys_s) - 1)
            found = keys_s[ji] == hk
            hmsg = np.where(found, vals_s[ji].astype(np.int64), -1).tolist()
        pending = [h for h, (c, p, di) in enumerate(hits)
                   if hmsg[h] < 0 and not inverted[di] and p + need < T]
        if pending and dibits_dev is not None:
            pc = np.asarray([hits[h][0] for h in pending], dtype=np.int64)
            pp = np.asarray([hits[h][1] for h in pending], dtype=np.int64)
            extra = self.nid_decode_positions(dibits_dev, pc, pp)
            for h, m in zip(pending, extra):
                hmsg[h] = int(m)
        acc_c, acc_t, fch, forder = [], [], [], []
        frame_end = {}
        n_order = {}
        for h, (c, p, di) in enumerate(hits):
            if inverted[di] or p + need >= T:
                continue
            if p < frame_end.get(c, -1):
                continue
            m = hmsg[h] if hmsg[h] >= 0 else 0xFFFF
            if (m & 0xF) not in (5, 10):
                continue
            frame_end[c] = p + need
            base = n_order.get(c, 0)
            acc_c.append(c)
            acc_t.append(p)
            fch.extend([c] * 9)
            forder.extend(range(base, base + 9))
            n_order[c] = base + 9
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    # -- voice decode --------------------------------------------------------
    def _ml_dec(self, words, pm, cb):
        Fw, M = words.shape[0], pm.shape[0]
        rows = max(1, TILE_BYTES // (4 * M))
        ms = []
        for r0 in range(0, Fw, rows):
            s = 1.0 - 2.0 * words[r0:r0 + rows].to(torch.float32)
            ms.append(torch.argmax(self.mm(s, pm.T), dim=-1))
        m = torch.cat(ms) if ms else torch.zeros(0, dtype=torch.int64,
                                                 device=words.device)
        errs = (cb[m] != words).sum(dim=-1, dtype=torch.int32)
        return m, errs

    def imbe_ecc_batch(self, bits144):
        t = self.tables
        Fn = bits144.shape[0]
        x = bits144.to(torch.uint8)
        fr = x[:, t.ecc_gather].reshape(Fn, 8, 23)
        m0, errs = self._ml_dec(fr[:, 0], t.golay_pm, t.golay_cb)
        pnb = t.ecc_pn[t.ecc_seed_of_msg[m0]]
        parts = [t.ecc_param_g[m0]]
        pos = 0
        for row in range(1, 4):
            w = fr[:, row] ^ pnb[:, pos:pos + 23].flip(-1)
            pos += 23
            m, e = self._ml_dec(w, t.golay_pm, t.golay_cb)
            errs = errs + e
            parts.append(t.ecc_param_g[m])
        for row in range(4, 7):
            w = fr[:, row, :15] ^ pnb[:, pos:pos + 15].flip(-1)
            pos += 15
            m, e = self._ml_dec(w, t.h15_pm, t.h15_cb)
            errs = errs + e
            parts.append(t.ecc_param_h[m])
        parts.append(fr[:, 7, :7].flip(-1))
        return torch.cat(parts, dim=1), errs

    def _headers(self, S):
        t = self.tables
        dev = S.device
        gain = self.mm(S[:, t.gain_pos], _weights(6, dev).to(torch.float32))
        b0 = self.mm(S[:, t.b0_hi_pos],
                     _weights(8, dev)[:6].to(torch.float32))
        lo0, lo1 = t.b0_lo_pos
        b0 = b0 + (S[:, lo0] * 2.0 + S[:, lo1])
        b0c = torch.clamp(b0, 0.0, 207.0)
        w0 = torch.full_like(b0c, 4.0 * math.pi) / (b0c + 39.5)
        L = torch.floor(0.9254 * torch.floor(torch.full_like(w0, math.pi)
                                             / w0 + 0.25)).to(torch.int64)
        L = torch.clamp(L, L_MIN, MAX_L)
        K = torch.clamp((L + 2) // 3, max=12)
        return gain, w0, L, K

    def _per_frame_matvec(self, x, table, li):
        Fn = x.shape[0]
        per = table.shape[1] * table.shape[2] * 4
        rows = max(1, TILE_BYTES // per)
        out = [self.mm(x[r:r + rows, None, :], table[li[r:r + rows]])[:, 0]
               for r in range(0, Fn, rows)]
        if not out:
            return x.new_zeros((0, table.shape[2]))
        return torch.cat(out)

    def _transforms(self, S):
        t = self.tables
        Sf = S.to(torch.float32)
        gain, w0, L, K = self._headers(Sf)
        li = L - L_MIN
        bits = torch.gather(Sf, 1, t.dq_pos[li])
        codes = self._per_frame_matvec(bits, t.dq_w, li)
        x = (codes - t.dq_offs[li]) * t.dq_steps[li]
        G1 = t.gain_min + gain * t.gain_step
        coef = torch.cat([G1[:, None], x], dim=1)
        T = self._per_frame_matvec(coef, t.dq_a, li)
        return T, w0, L, K

    @staticmethod
    def prediction_scan(T, w0, L, K, V, act, prev_logm, prev_L,
                        pred_decay, amp_scale):
        C, Tn = w0.shape
        dev = T.device
        lidx = torch.arange(1, MAX_L + 1, dtype=torch.float32,
                            device=dev)[None]
        lband = (torch.arange(MAX_L, device=dev) // 3)[None]
        p_logm, p_L = prev_logm, prev_L
        w0s, voiced, amps = [], [], []
        for t in range(Tn):
            T_t, w0_t, L_t, K_t, V_t, a_t = (T[:, t], w0[:, t], L[:, t],
                                             K[:, t], V[:, t], act[:, t])
            Lf = L_t.to(torch.float32)[:, None]
            pl = p_L.to(torch.float32)[:, None]
            Lden = torch.clamp(Lf, min=1.0)
            k = torch.where(pl > 0, lidx * pl / Lden, 1.0) - 1.0
            kmax = torch.clamp(p_L - 1, min=0).to(torch.int64)[:, None]
            k0 = torch.minimum(torch.clamp(torch.floor(k).to(torch.int64),
                                           min=0), kmax)
            k1 = torch.minimum(k0 + 1, kmax)
            frac = torch.clamp(k - k0.to(torch.float32), 0.0, 1.0)
            g0 = torch.gather(p_logm, 1, k0)
            g1 = torch.gather(p_logm, 1, k1)
            pred_full = (1.0 - frac) * g0 + frac * g1
            mask = (lidx <= Lf).to(torch.float32)
            pvalid = pred_full * mask
            pmean = pvalid.sum(dim=1, keepdim=True) / Lden
            pred = pred_decay * (pvalid - pmean) * mask
            has_prev = (p_L > 0)[:, None]
            logm = (T_t + torch.where(has_prev, pred, 0.0)) * mask
            band = torch.minimum(lband, (K_t - 1).to(torch.int64)[:, None])
            v = torch.gather(V_t, 1, band) * mask
            am = a_t[:, None].to(torch.float32)
            p_logm = torch.where(am > 0, logm, p_logm)
            p_L = torch.where(a_t > 0, L_t.to(p_L.dtype), p_L)
            amps.append(torch.exp2(torch.clamp(logm, -4.0, 14.0)) * mask
                        * amp_scale * am)
            w0s.append(w0_t * a_t)
            voiced.append(v * am)
        if Tn == 0:
            return (w0.new_zeros((C, 0)), T.new_zeros((C, 0, MAX_L)),
                    T.new_zeros((C, 0, MAX_L)), p_logm, p_L)
        return (torch.stack(w0s, 1), torch.stack(voiced, 1),
                torch.stack(amps, 1), p_logm, p_L)

    def _b0_code(self, bits88):
        t = self.tables
        hi = bits88[:, t.b0_hi_pos].to(torch.int64)
        b0 = (hi * _weights(8, hi.device)[:6]).sum(-1)
        lo0, lo1 = t.b0_lo_pos
        return (b0 | (bits88[:, lo0].to(torch.int64) << 1)
                | bits88[:, lo1].to(torch.int64))

    def imbe_frame_good(self, bits88, errs):
        b0 = self._b0_code(bits88)
        return ((errs <= 5) & (b0 <= 207)).to(torch.float32)

    def imbe_tone_params(self, bits88):
        t = self.tables
        b0 = self._b0_code(bits88)
        w7 = _weights(7, bits88.device)
        b = bits88.to(torch.int64)
        id1 = (b[:, 12:19] * w7).sum(-1)
        id2 = (b[:, 19:26] * w7).sum(-1)
        ad = (b[:, 26:33] * w7).sum(-1)
        is_tone = ((b0 >= t.tone_b0_min) & (b0 <= t.tone_b0_max)
                   & (id1 == id2))
        w0_t = (2.0 * math.pi * TONE_FREQ_STEP_HZ / 8000.0) \
            * id1.to(torch.float32)
        amp_t = ad.to(torch.float32) * (TONE_AMP_STEP / 8000.0)
        return is_tone, w0_t, amp_t

    @staticmethod
    def repeat_gate(w0s, Vs, As, good, present, state,
                    max_repeat: int = MAX_REPEAT):
        C, T = w0s.shape
        Lh = Vs.shape[-1]
        dev = w0s.device
        lw0, lV, lA, rep_in, valid_in = state
        goode = torch.cat([valid_in[:, None] > 0, good > 0], dim=1)
        pb = present * (1.0 - good)
        pbe = torch.cat([rep_in.to(torch.float32)[:, None], pb], dim=1)
        pbcum = torch.cumsum(pbe, dim=1)
        sidx = torch.arange(T + 1, dtype=torch.int64, device=dev)[None]
        gidx = torch.cummax(torch.where(goode, sidx, -1), dim=1).values
        has = gidx >= 0
        gi = torch.clamp(gidx, min=0)
        reps = pbcum - torch.gather(pbcum, 1, gi)
        w0e = torch.cat([lw0[:, None], w0s], dim=1)
        Ve = torch.cat([lV[:, None], Vs], dim=1)
        Ae = torch.cat([lA[:, None], As], dim=1)
        use = ((good > 0) | ((present > 0) & has[:, 1:]
                             & (reps[:, 1:] <= max_repeat))
               ).to(torch.float32)
        t1 = gi[:, 1:]
        t1e = t1[:, :, None].expand(C, T, Lh)
        w0r = torch.gather(w0e, 1, t1) * use
        Vr = torch.gather(Ve, 1, t1e) * use[:, :, None]
        Ar = torch.gather(Ae, 1, t1e) * use[:, :, None]
        glast = gi[:, -1:]
        gle = glast[:, :, None].expand(C, 1, Lh)
        lw0_o = torch.gather(w0e, 1, glast)[:, 0]
        lV_o = torch.gather(Ve, 1, gle)[:, 0]
        lA_o = torch.gather(Ae, 1, gle)[:, 0]
        rep_o = torch.clamp(pbcum[:, -1]
                            - torch.gather(pbcum, 1, glast)[:, 0],
                            0, max_repeat + 1).to(torch.int32)
        valid_o = has[:, -1].to(torch.float32)
        return (w0r, Vr, Ar), (lw0_o, lV_o, lA_o, rep_o, valid_o)

    @staticmethod
    def noise_phases(C: int, n_steps: int, device) -> torch.Tensor:
        i = torch.arange(C * n_steps * MAX_L, dtype=torch.float32,
                         device=device)
        return floor_mod(i * 2.399963, 2 * math.pi).reshape(C, n_steps,
                                                             MAX_L)

    @staticmethod
    def _scatter(vals, fch, forder, C, n_steps, dtype):
        z = torch.zeros((C + 1, n_steps) + tuple(vals.shape[1:]),
                        dtype=dtype, device=vals.device)
        z[fch, forder] = vals.to(dtype)
        return z[:C]

    # -- synthesis -----------------------------------------------------------
    @staticmethod
    def _phase(w0, theta_in, w_in):
        dev = w0.device
        n_idx = torch.arange(N, dtype=torch.float32, device=dev)
        w_prev0 = torch.where(w_in <= 0.0, w0[:, 0], w_in)
        w_prev = torch.cat([w_prev0[:, None], w0[:, :-1]], dim=1)
        alpha = (n_idx + 1.0) * torch.tensor(1.0 / N, dtype=torch.float32,
                                             device=dev)
        w_t = fma_f32((w0 - w_prev)[..., None], alpha, w_prev[..., None])
        cum = blocked_cumsum(w_t)
        frame_adv = cum[..., -1]
        if w0.shape[1] > 1:
            theta0 = torch.cat([torch.zeros_like(frame_adv[:, :1]),
                                blocked_cumsum(frame_adv[:, :-1])], dim=1)
        else:
            theta0 = torch.zeros_like(frame_adv)
        theta0 = floor_mod(theta_in[:, None] + theta0, 2 * math.pi)
        theta = theta0[..., None] + cum
        theta_out = floor_mod(theta_in + tree_sum(frame_adv), 2 * math.pi)
        return theta, theta_out, alpha

    def _synth_chunk(self, theta, alpha, w0, amps, voiced, noise_phase,
                     w_in, a_in):
        t = self.tables
        dev = w0.device
        a_prev0 = torch.where((w_in <= 0.0)[:, None], amps[:, 0], a_in)
        a_prev = torch.cat([a_prev0[:, None], amps[:, :-1]], dim=1)
        v = voiced > 0.5
        P = v.to(torch.float32)
        pr = torch.cos(theta)[..., None]
        pi = torch.sin(theta)[..., None]
        while pr.shape[-1] < MAX_L:
            zkr = pr[..., -1:]
            zki = pi[..., -1:]
            pr, pi = (torch.cat([pr, pr * zkr - pi * zki], dim=-1),
                      torch.cat([pi, pr * zki + pi * zkr], dim=-1))
        pr = pr[..., :MAX_L]
        del pi
        cc = torch.stack([amps * P, a_prev * P], dim=-1)
        S = self.mm(pr, cc)
        del pr
        pcm = 2.0 * (alpha * S[..., 0] + (1.0 - alpha) * S[..., 1])
        L = amps.shape[-1]
        w0_safe = torch.clamp(w0, min=1e-3)[..., None]
        wbin = torch.tensor(2.0 * math.pi / N, dtype=torch.float32,
                            device=dev)
        l_raw = torch.floor(t.synth_bin_w / w0_safe + 0.5).to(torch.int64)
        in_band = (l_raw >= 1) & (l_raw <= L)
        li = torch.clamp(l_raw, 1, L) - 1
        a_k = torch.gather(amps, 2, li)
        uv_k = 1.0 - torch.gather(P, 2, li)
        c_k = (2.0 * a_k * torch.sqrt(wbin / w0_safe) * uv_k
               * in_band.to(torch.float32))
        phi = noise_phase[..., t.synth_bin_l] + t.synth_phi_off
        pcm = pcm + (self.mm(c_k * torch.cos(phi), t.synth_bin_cos)
                     + self.mm(c_k * torch.sin(phi), t.synth_bin_sin))
        return pcm

    def synthesize_stream(self, w0, amps, voiced, noise_phase, theta_in,
                          w_in, a_in):
        C, Fn = w0.shape
        theta, theta_out, alpha = self._phase(w0, theta_in, w_in)
        per_channel = max(1, Fn * N * MAX_L * 4)
        step = max(1, TILE_BYTES // per_channel)
        pcm = torch.cat([self._synth_chunk(
            theta[s:s + step], alpha, w0[s:s + step], amps[s:s + step],
            voiced[s:s + step], noise_phase[s:s + step], w_in[s:s + step],
            a_in[s:s + step]) for s in range(0, C, step)])
        return pcm, theta_out, w0[:, -1], amps[:, -1]

    # -- one block -----------------------------------------------------------
    def zero_carry(self):
        """(prediction, synthesis, repeat) carries of a fresh pipeline."""
        C, dev = self.C, self.device
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        return ((z(C, MAX_L), torch.zeros(C, dtype=torch.int32, device=dev)),
                (z(C), z(C), z(C, MAX_L)),
                (z(C), z(C, MAX_L), z(C, MAX_L),
                 torch.zeros(C, dtype=torch.int32, device=dev), z(C)))

    def decode(self, fe, carry):
        """Pick and voice decode of a finished front end from ``carry``
        (None: a fresh pipeline's) → (frames, wire ``[C, T/2]`` uint8 on
        the host, carry out, padded steps); frames are (bits88 ``[F, 88]``,
        errs ``[F]``, frame channel, frame step, margin ``[F]``: how close
        the frame's nearest dibit lies to a slicer threshold, in soft
        symbol units) as numpy, or None."""
        dibits_dev, idx, vq, dq, msg, n_sym, soft = fe
        ac, at, fch, forder = self.pick_ldus(idx, vq, dq, msg, n_sym,
                                             dibits_dev=dibits_dev)
        L = ac.shape[0]
        if L == 0:
            return None, None, carry, 0
        if carry is None:
            carry = self.zero_carry()
        n_steps = int(forder.max()) + 1
        Lp = -(-L // 32) * 32
        Tp = -(-n_steps // 27) * 27
        C, dev, t = self.C, self.device, self.tables
        acp = np.full(Lp, C, dtype=np.int64)
        acp[:L] = ac
        atp = np.zeros(Lp, dtype=np.int64)
        atp[:L] = at
        fchp = np.full(Lp * 9, C, dtype=np.int64)
        fchp[:L * 9] = fch
        fordp = np.zeros(Lp * 9, dtype=np.int64)
        fordp[:L * 9] = forder
        (prev_logm, prev_L), synth_in, rep_in = carry
        # the LDUs' voice frames gathered from the dibits on the device
        Tn = dibits_dev.shape[1]
        pos = torch.clamp(torch.as_tensor(atp, device=dev)[:, None, None]
                          + self._frame_offs[None], 0, Tn - 1)
        ch = torch.clamp(torch.as_tensor(acp, device=dev),
                         max=dibits_dev.shape[0] - 1)
        dd = dibits_dev[ch[:, None, None], pos].reshape(-1, 72)
        sd = soft[ch[:, None, None], pos].reshape(-1, 72).abs()
        margin = torch.minimum(sd, (sd - 2.0).abs()).amin(-1)
        frames144 = torch.stack([(dd >> 1) & 1, dd & 1], dim=-1
                                ).reshape(-1, 144).to(torch.uint8)
        fch_t = torch.as_tensor(fchp, device=dev)
        ford_t = torch.as_tensor(fordp, device=dev)
        bits88, errs = self.imbe_ecc_batch(frames144)
        # prediction inputs
        Tt, w0, Lh, K = self._transforms(bits88)
        vs = t.voicing_start
        V = bits88[:, vs:vs + N_BANDS]
        good = self.imbe_frame_good(bits88, errs)
        f32, i32 = torch.float32, torch.int32
        scat = lambda v, dt: self._scatter(v, fch_t, ford_t, C, Tp, dt)
        grids = (scat(Tt, f32), scat(w0, f32),
                 torch.clamp(scat(Lh, i32), min=1),
                 torch.clamp(scat(K, i32), min=1), scat(V, f32),
                 scat(good, f32))
        act = grids[-1]
        w0o, voiced, amps, f_logm, f_L = self.prediction_scan(
            *grids, prev_logm, prev_L, t.pred_decay, t.imbe_amp_scale)
        scatf = lambda v: self._scatter(v, fch_t, ford_t, C, Tp, f32)
        is_tone, w0_t, amp_t = self.imbe_tone_params(bits88)
        tone_f = (is_tone & (errs <= 5)).to(f32)
        tones = scatf(tone_f)
        w0_ts = scatf(w0_t * tone_f)
        amp_ts = scatf(amp_t * tone_f)
        e0 = torch.zeros((1, 1, MAX_L), dtype=f32, device=dev)
        e0[0, 0, 0] = 1.0
        ton = tones[:, :, None] > 0
        w0o = torch.where(tones > 0, w0_ts, w0o)
        voiced = torch.where(ton, e0, voiced)
        amps = torch.where(ton, e0 * (amp_ts * 0.5)[:, :, None], amps)
        present = scatf(torch.ones_like(tone_f))
        (w0o, voiced, amps), rep_out = self.repeat_gate(
            w0o, voiced, amps, torch.maximum(act, tones), present, rep_in)
        noise = self.noise_phases(C, Tp, dev)
        pcm, t_out, w_out, a_out = self.synthesize_stream(
            w0o, amps, voiced, noise, *synth_in)
        p = torch.clamp(pcm * PCM_SCALE, -1.0, 1.0)
        wire = adpcm_compress_np(p.reshape(C, -1).cpu().numpy(),
                                 t.adpcm_step, t.adpcm_index)
        frames = (bits88[:L * 9].cpu().numpy(), errs[:L * 9].cpu().numpy(),
                  fch, forder, margin[:L * 9].cpu().numpy())
        return frames, wire, ((f_logm, f_L), (t_out, w_out, a_out),
                              rep_out), Tp

    def expand(self, wire) -> np.ndarray:
        """The wire → ``[C, N]`` float32 PCM (empty without a frame)."""
        if wire is None:
            return np.zeros((self.C, 0), dtype=np.float32)
        return adpcm_expand_np(wire, self.tables.adpcm_step,
                               self.tables.adpcm_index)
