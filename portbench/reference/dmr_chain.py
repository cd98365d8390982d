"""The plain DMR BS two-slot voice chain the benchmark holds the port to.

A frozen copy of the port's plain DMR path as it stood at commit
eba076e95be0b9cb2558d566856d75cd57827eda (``dsdneo_tpu_torch``), so a
later change to the port cannot move the yardstick.  It imports nothing
of the port: its tables and test vector come from
``portbench/data/dmr_tables.npz`` (a copy of the port's DMR tables file
at that commit).

Copied from, function by function:

- ``engine/dmrbatch.py``: ``_sf_frame_offsets``, ``_dibits_to_bits``,
  ``EMB_DIBITS``, ``SF_PERIOD``, ``SF_EXTENT``, and of
  ``BatchedDmrVoicePipeline`` ``sync_candidates`` (the sync filter and
  the stable top-K), ``emb_errors`` (the EMB QR(16,7,6) decode),
  ``pick_superframes`` and the padding of ``decode_from_frontend``;
  ``dmr_voice_decode_gather``;
- ``fec/device.py``: ``ambe_ecc_batch``;
- ``vocoder/device.py``: ``_field``, ``ambe_decode_params``,
  ``ambe_tone_params``, ``ambe_params_gated``, ``voice_state_init``,
  ``scatter_repeat_synth``;
- ``params.py``: the tensors of ``DmrTables`` this chain reads.

Taken from the frozen P25 chain (``p25_chain.py``, a copy of the port
at commit 1acf1f855b4962341c6932295300c03c25b32489), because the port's
functions compute the same at both commits (the later one only makes
its constants once per device; ``portbench/tests/test_portbench_dmr_chain.py``
holds each to the port's on the CPU): the front end (``_fir_real``,
``fir_complex``, ``fm_discriminate``, ``frontend_step``,
``symbolize_step``, ``slice_four_level``: kernel K1's plain version is
``fm_discriminate(fir_complex(x, taps))``), ``correlate_syncs``
(``engine/voicebatch.correlate_syncs_device``), ``_ml_dec``,
``_per_frame_matvec``, ``repeat_gate``, ``noise_phases``, ``_scatter``,
the synthesis (``_phase``, ``_synth_chunk``, ``synthesize_stream``),
``adpcm_compress_np`` (kernel K3's plain version, in NumPy on the host)
and ``adpcm_expand_np`` (the host decoder's plain version).

As in the P25 chain, ``tf32`` rounds the inputs of every product and of
the channel FIR to TF32 (10 mantissa bits): the precision below the
configuration's float32, which is the control that has to fail.
"""

from __future__ import annotations

import math
import os
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference.p25_chain import (MAX_L, N_BINS, L_MIN, PCM_SCALE,
                                           TONE_AMP_STEP, TONE_FREQ_STEP_HZ,
                                           P25Chain, adpcm_compress_np,
                                           adpcm_expand_np, fma_f32)

DATA_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "dmr_tables.npz")
SF_PERIOD = 288                 # same-slot burst period in dibits
SF_EXTENT = SF_PERIOD * 5 + 78  # dibits past the sync start
EMB_DIBITS = (0, 1, 2, 3, 20, 21, 22, 23)
SYNC_TOPK = 128
AMBE_ERR_THR = 3                # ambe_params_gated's threshold


# -- tables ------------------------------------------------------------------
def read_npz(path: str = DATA_NPZ) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_vector(path: str = DATA_NPZ) -> dict[str, np.ndarray]:
    """The frozen test vector: ``dibits`` (the two-slot stream) and
    ``bits49`` ``[2, 144, 49]`` (each slot's AMBE frames), the ``tv_``
    arrays."""
    return {k[3:]: v for k, v in read_npz(path).items()
            if k.startswith("tv_")}


def load_tables(device, path: str = DATA_NPZ) -> SimpleNamespace:
    """The DMR voice path's constants as tensors on ``device`` (the
    port's ``DmrTables``, the attributes this chain and the P25 chain's
    shared parts read)."""
    t = read_npz(path)
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    u8 = lambda a: torch.as_tensor(np.asarray(a, np.uint8), device=dev)
    kk = np.arange(N_BINS)
    return SimpleNamespace(
        np=t,
        taps=f32(t["taps"]), symbol_rate=float(t["symbol_rate"]),
        four_level=bool(t["four_level"]), sync_levels=f32(t["sync_levels"]),
        sync_inverted=tuple(bool(x) for x in t["sync_inverted"]),
        sync_len=int(t["sync_levels"].shape[1]),
        golay_cb=u8(t["golay_codebook"]),
        golay_pm=f32(1.0 - 2.0 * t["golay_codebook"]),
        qr_cb=u8(t["qr_codebook"]), qr_pm=f32(1.0 - 2.0 * t["qr_codebook"]),
        ambe_gather=i64(t["ambe_gather"].reshape(-1)),
        ambe_pn=u8(t["ambe_pn"]), ambe_parity=u8(t["ambe_parity"]),
        ambe_param=u8(t["ambe_param"]), ambe_w=f32(t["ambe_w"]),
        ambe_c=f32(t["ambe_c"]), ambe_assigned=f32(t["ambe_assigned"]),
        adpcm_step=t["adpcm_step"].astype(np.int32),
        adpcm_index=t["adpcm_index"].astype(np.int32),
        synth_bin_w=f32(t["synth_bin_w"]),
        synth_bin_cos=f32(t["synth_bin_cos"]),
        synth_bin_sin=f32(t["synth_bin_sin"]),
        synth_phi_off=f32((2.399963 * (kk // MAX_L) * (kk + 3)
                           ).astype(np.float32)),
        synth_bin_l=torch.as_tensor(kk % MAX_L, dtype=torch.int64,
                                    device=dev))


# -- small helpers -----------------------------------------------------------
def _sf_frame_offsets() -> np.ndarray:
    rows = []
    for k in range(6):
        s = SF_PERIOD * k
        rows.append(np.arange(s - 54, s - 18))
        rows.append(np.concatenate([np.arange(s - 18, s),
                                    np.arange(s + 24, s + 42)]))
        rows.append(np.arange(s + 42, s + 78))
    return np.stack(rows).astype(np.int32)


def _dibits_to_bits(dd: torch.Tensor) -> torch.Tensor:
    return torch.stack([(dd >> 1) & 1, dd & 1], dim=-1
                       ).reshape(*dd.shape[:-1], -1).to(torch.uint8)


def _weights(n: int, device) -> torch.Tensor:
    return torch.tensor([1 << (n - 1 - i) for i in range(n)],
                        dtype=torch.int64, device=device)


def _field(bits: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    return (bits[:, lo:lo + n].to(torch.int64)
            * _weights(n, bits.device)).sum(-1)


def expected_frames(tv: dict, lead: int, n_sym: int):
    """The superframes of the vector a block of ``n_sym`` symbols holds
    whole after ``lead`` filler dibits, in stream order (the two slots
    alternate): (sync positions ``[S]``, parameter bits ``[S, 18, 49]``);
    a copy of the port's ``protocol/dmr/encode.expected_frames``, whose
    bounds are the picker's (t ≥ 54, t + ``SF_EXTENT`` < n_sym)."""
    first_sync = 90 + 66
    bits49 = tv["bits49"]
    n_sf = bits49.shape[1] // 18
    pos, bits = [], []
    for j in range(n_sf):
        for slot in (0, 1):
            t = lead + first_sync + SF_PERIOD * 6 * j + 144 * slot
            if t >= 54 and t + SF_EXTENT < n_sym:
                pos.append(t)
                bits.append(bits49[slot, 18 * j:18 * (j + 1)])
    return (np.asarray(pos, np.int64),
            np.stack(bits) if bits else np.zeros((0, 18, 49), np.uint8))


class DmrChain:
    """The plain chain over ``[C, B, 2]`` float32 I/Q blocks on
    ``device``, one block at a time from a given carry; ``tf32`` rounds
    the inputs of every product and of the channel FIR to TF32.  The
    parts the P25 chain shares run on ``base``, a ``P25Chain`` over this
    chain's tables."""

    def __init__(self, C: int, fs: float = 48000.0, device="cpu",
                 tables=None, tf32: bool = False,
                 sync_threshold: float = 0.62):
        self.device = torch.device(device)
        self.tables = tables if tables is not None else load_tables(device)
        self.base = P25Chain(C, fs, self.device, tables=self.tables,
                             tf32=tf32, sync_threshold=sync_threshold)
        self.C = C
        self.fs = fs
        self.sps = fs / self.tables.symbol_rate
        self.threshold = sync_threshold
        self._offs = torch.as_tensor(_sf_frame_offsets().astype(np.int64),
                                     device=self.device)
        self._emb_offs = torch.as_tensor(EMB_DIBITS, dtype=torch.int64,
                                         device=self.device)

    # -- front end + sync + EMB gate -----------------------------------------
    def soft_symbols(self, iq) -> torch.Tensor:
        """The chain's ``[C, T]`` soft symbols of a block."""
        return self._front(iq)[1]

    def _front(self, iq):
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // self.sps) - 2
        t = self.tables
        dibits, soft, _power = self.base.frontend_step(
            x, t.taps, self.sps, n_sym, t.four_level)
        return dibits, soft, n_sym

    def emb_errors(self, dibits, idx, dq):
        t = self.tables
        Cn, Tn = dibits.shape
        rows = torch.arange(Cn, device=self.device)[:, None, None]
        inv2 = ((dq & 1) * 2)[:, :, None]
        errs_tot = torch.zeros(idx.shape, dtype=torch.int32,
                               device=self.device)
        for burst in (1, 2):
            base = torch.clamp(idx + SF_PERIOD * burst, 0, Tn - 25)
            dd = dibits[rows, base[:, :, None] + self._emb_offs] ^ inv2
            b16 = _dibits_to_bits(dd)
            s = 1.0 - 2.0 * b16.to(torch.float32)
            m = torch.argmax(self.base.mm(s, t.qr_pm.T), dim=-1)
            errs_tot += (t.qr_cb[m] != b16).sum(dim=-1, dtype=torch.int32)
        return torch.clamp(errs_tot, 0, 255).to(torch.uint8)

    def frontend(self, iq):
        """Front end, sync filter and EMB gate of one block: (dibits on
        the device, idx int64, vq, dq, eq uint8 on the host, n_sym, soft
        symbols on the device)."""
        dibits, soft, n_sym = self._front(iq)
        t = self.tables
        sc = self.base.correlate_syncs(soft, t.sync_levels)
        best_def = torch.argmax(sc, dim=1).to(torch.uint8)
        bs = torch.amax(sc, dim=1)
        k_cand = min(SYNC_TOPK, n_sym - t.sync_len + 1)
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k_cand], idx[:, :k_cand]
        vq = torch.clamp(vals * 127.0, 0, 255).to(torch.uint8)
        dq = torch.gather(best_def, 1, idx)
        eq = self.emb_errors(dibits, idx, dq)
        return (dibits, idx.cpu().numpy().astype(np.int64),
                vq.cpu().numpy(), dq.cpu().numpy(), eq.cpu().numpy(), n_sym,
                soft)

    # -- host superframe picker ----------------------------------------------
    def pick_superframes(self, idx, vq, dq, eq, n_sym: int):
        inverted = self.tables.sync_inverted
        acc_c, acc_t, acc_i, fch, forder = [], [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = (sc >= self.threshold) & (eq[c] <= 2)
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order].tolist()
            pdefs = dq[c][ok][order].tolist()
            svals = sc[ok][order].tolist()
            n_order = 0
            last = -10 ** 9
            j = 0
            n_cand = len(positions)
            while j < n_cand:
                t = positions[j]
                if t - last < 24:
                    j += 1
                    continue
                w = j
                k = j + 1
                while k < n_cand and positions[k] < t + 8:
                    if svals[k] > svals[w]:
                        w = k
                    k += 1
                t = positions[w]
                dfi = pdefs[w]
                j = k
                if t < 54 or t + SF_EXTENT >= n_sym:
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
                acc_i.append(1 if inverted[int(dfi)] else 0)
                fch.extend([c] * 18)
                forder.extend(range(n_order, n_order + 18))
                n_order += 18
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_i, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    # -- AMBE+2 ECC and parameters -------------------------------------------
    def ambe_ecc_batch(self, bits72):
        t = self.tables
        Fn = bits72.shape[0]
        fr = bits72.to(torch.uint8)[:, t.ambe_gather].reshape(Fn, 4, 24)
        m0, errs = self.base._ml_dec(fr[:, 0, :23], t.golay_pm, t.golay_cb)
        errs = errs + (t.ambe_parity[m0] != fr[:, 0, 23]).to(torch.int32)
        m1, e1 = self.base._ml_dec(fr[:, 1, :23] ^ t.ambe_pn[m0],
                                   t.golay_pm, t.golay_cb)
        out = torch.cat([t.ambe_param[m0], t.ambe_param[m1],
                         fr[:, 2, :11], fr[:, 3, :14]], dim=1)
        return out, errs + e1

    def ambe_decode_params(self, bits49):
        t, mm = self.tables, self.base.mm
        dev = bits49.device
        S = bits49.to(torch.float32)
        b0 = mm(S[:, 0:7], _weights(7, dev).to(torch.float32))
        y = fma_f32(torch.full_like(b0, 0.021336), b0 + 0.5,
                    torch.full_like(b0, 4.3118))
        period = torch.pow(2.0, y.double()).float()
        w0 = torch.full_like(b0, 2.0 * math.pi) / torch.clamp(period, 19.0,
                                                              131.0)
        L = torch.floor(0.9254 * torch.floor(torch.full_like(w0, math.pi)
                                             / w0 + 0.25)).to(torch.int64)
        L = torch.clamp(L, L_MIN, MAX_L)
        li = L - L_MIN
        Lf = L.to(torch.float32)[:, None]
        lidx = torch.arange(MAX_L, device=dev)[None, :]
        mask = (lidx < L[:, None]).to(torch.float32)
        band = torch.clamp((lidx * 5) // L[:, None], max=4)
        voiced = torch.gather(S[:, 7:12], 1, band) * mask
        gain_idx = mm(S[:, 12:18], _weights(6, dev).to(torch.float32))
        gain = torch.pow(torch.full_like(gain_idx, 10.0),
                         (gain_idx - 32.0) * 1.3 * 0.05)
        r = self.base._per_frame_matvec(S[:, 18:49], t.ambe_w, li) \
            + t.ambe_c[li]
        amps = torch.where(t.ambe_assigned[li] > 0,
                           torch.pow(torch.full_like(r, 10.0), 0.3 * r), 1.0)
        tilt = torch.exp(-0.02 * torch.arange(MAX_L, dtype=torch.float32,
                                              device=dev))[None, :]
        amps = amps * tilt * mask
        rms = torch.sqrt(torch.sum(amps ** 2, dim=1, keepdim=True)
                         / torch.clamp(Lf, min=1.0))
        amps = amps / torch.clamp(rms, min=1e-9) * gain[:, None] * 0.02
        return w0, L.to(torch.int32), voiced, amps * mask

    @staticmethod
    def ambe_tone_params(bits49):
        id1 = _field(bits49, 7, 7)
        is_tone = ((_field(bits49, 0, 7) == 0x7F)
                   & (id1 == _field(bits49, 21, 7)))
        w0_t = (2.0 * math.pi * TONE_FREQ_STEP_HZ / 8000.0) \
            * id1.to(torch.float32)
        amp_t = _field(bits49, 14, 7).to(torch.float32) \
            * (TONE_AMP_STEP / 8000.0)
        return is_tone, w0_t, amp_t

    def ambe_params_gated(self, bits49, errs, thr: int = AMBE_ERR_THR):
        w0, _L, voiced, amps = self.ambe_decode_params(bits49)
        is_tone, w0_t, amp_t = self.ambe_tone_params(bits49)
        e0 = (torch.arange(MAX_L, device=bits49.device) == 0
              ).to(torch.float32)
        ton = is_tone[:, None]
        w0 = torch.where(is_tone, w0_t, w0)
        voiced = torch.where(ton, e0, voiced)
        amps = torch.where(ton, e0 * (amp_t * 0.5)[:, None], amps)
        return w0, voiced, amps, (errs <= thr).to(torch.float32)

    # -- one block -----------------------------------------------------------
    def zero_carry(self):
        """(synthesis, repeat) carries of a fresh pipeline."""
        C, dev = self.C, self.device
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        return ((z(C), z(C), z(C, MAX_L)),
                (z(C), z(C, MAX_L), z(C, MAX_L),
                 torch.zeros(C, dtype=torch.int32, device=dev), z(C)))

    def decode(self, fe, carry):
        """Pick and voice decode of a finished front end from ``carry``
        (None: a fresh pipeline's) → (frames, wire ``[C, T/2]`` uint8 on
        the host, carry out, padded steps); frames are (bits49 ``[F,
        49]``, errs ``[F]``, frame channel, frame step, margin ``[F]``:
        how close the frame's nearest dibit lies to a slicer threshold,
        in soft symbol units) as numpy, or None."""
        dibits_dev, idx, vq, dq, eq, n_sym, soft = fe
        ac, at, ai, fch, forder = self.pick_superframes(idx, vq, dq, eq,
                                                        n_sym)
        S = ac.shape[0]
        if S == 0:
            return None, None, carry, 0
        if carry is None:
            carry = self.zero_carry()
        n_steps = int(forder.max()) + 1
        Sp = -(-S // 16) * 16
        Tp = -(-n_steps // 36) * 36
        C, dev, t = self.C, self.device, self.tables

        def padded(a, n, fill):
            out = np.full(n, fill, dtype=np.int64)
            out[:a.shape[0]] = a
            return torch.as_tensor(out, device=dev)

        sf_ch, sf_pos = padded(ac, Sp, C), padded(at, Sp, 0)
        sf_inv = padded(ai, Sp, 0)
        fch_t, ford_t = padded(fch, Sp * 18, C), padded(forder, Sp * 18, 0)
        # the superframes' AMBE frames gathered from the dibits
        Tn = dibits_dev.shape[1]
        pos = torch.clamp(sf_pos[:, None, None] + self._offs[None], 0, Tn - 1)
        ch = torch.clamp(sf_ch, max=dibits_dev.shape[0] - 1)
        dd = dibits_dev[ch[:, None, None], pos]
        dd = (dd ^ (sf_inv[:, None, None] * 2).to(dd.dtype)).reshape(-1, 36)
        sd = soft[ch[:, None, None], pos].reshape(-1, 36).abs()
        margin = torch.minimum(sd, (sd - 2.0).abs()).amin(-1)
        bits49, errs = self.ambe_ecc_batch(_dibits_to_bits(dd))
        w0, voiced, amps, good = self.ambe_params_gated(bits49, errs)
        # the tail: scatter, frame repeat, synthesis, wire
        b = self.base
        synth_in, rep_in = carry
        scat = lambda v: b._scatter(v, fch_t, ford_t, C, Tp, torch.float32)
        (w0r, Vr, Ar), rep_out = b.repeat_gate(
            scat(w0), scat(voiced), scat(amps), scat(good),
            scat(torch.ones_like(good)), rep_in)
        pcm, t_o, w_o, a_o = b.synthesize_stream(
            w0r, Ar, Vr, b.noise_phases(C, Tp, dev), *synth_in)
        p = torch.clamp(pcm * PCM_SCALE, -1.0, 1.0)
        wire = adpcm_compress_np(p.reshape(C, -1).cpu().numpy(),
                                 t.adpcm_step, t.adpcm_index)
        frames = (bits49[:S * 18].cpu().numpy(),
                  errs[:S * 18].cpu().numpy(), fch, forder,
                  margin[:S * 18].cpu().numpy())
        return frames, wire, ((t_o, w_o, a_o), rep_out), Tp

    def expand(self, wire) -> np.ndarray:
        """The wire → ``[C, N]`` float32 PCM (empty without a frame)."""
        if wire is None:
            return np.zeros((self.C, 0), dtype=np.float32)
        return adpcm_expand_np(wire, self.tables.adpcm_step,
                               self.tables.adpcm_index)
