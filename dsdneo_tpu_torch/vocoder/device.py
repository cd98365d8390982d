"""Device voice decode: LDU dibits → ECC → dequantization → prediction
(kernel K2) → tones and frame repeat → synthesis → PCM wire format.

Counterpart of ``dsdneo_tpu/vocoder/device.py`` (``_headers``,
``_transforms``, ``_prediction_scan``, ``imbe_frame_good``,
``imbe_tone_params``, ``repeat_gate``, the state helpers,
``_decode_from_frames`` and ``voice_decode_gather``).

On a CUDA tensor :func:`prediction_scan` launches ``csrc/imbe_pred.cu``
(the JAX package's ``lax.scan`` over frame steps as one launch); on a
CPU tensor it runs :func:`prediction_scan_plain`, a loop over steps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dsdneo_tpu_torch import kernels
from dsdneo_tpu_torch.dsp.frontend import floor_mod
from dsdneo_tpu_torch.fec.device import imbe_ecc_batch
from dsdneo_tpu_torch.ops.audio_wire import wire_encode
from dsdneo_tpu_torch.params import L_MIN, MAX_L, TILE_BYTES
from dsdneo_tpu_torch.vocoder.synth import synthesize_stream

N_BANDS = 12
MAX_REPEAT = 3                  # vocoder.glue.MAX_REPEAT
TONE_FREQ_STEP_HZ = 31.25
TONE_AMP_STEP = 75.0


def _weights(n: int, device) -> torch.Tensor:
    """MSB-first bit weights ``[2^(n-1), ..., 1]`` as int64."""
    return torch.tensor([1 << (n - 1 - i) for i in range(n)],
                        dtype=torch.int64, device=device)


def _headers(S: torch.Tensor, tables):
    """``[F, 88]`` float bits → (gain code, ω0, L, K)."""
    dev = S.device
    gain = S[:, tables.gain_pos] @ _weights(6, dev).to(torch.float32)
    b0 = S[:, tables.b0_hi_pos] @ _weights(8, dev)[:6].to(torch.float32)
    lo0, lo1 = tables.b0_lo_pos
    b0 = b0 + (S[:, lo0] * 2.0 + S[:, lo1])
    b0c = torch.clamp(b0, 0.0, 207.0)
    # constant numerators as full tensors: ``scalar / tensor`` would
    # multiply by a reciprocal and round differently from the JAX package
    w0 = torch.full_like(b0c, 4.0 * math.pi) / (b0c + 39.5)
    L = torch.floor(0.9254 * torch.floor(torch.full_like(w0, math.pi) / w0
                                         + 0.25)).to(torch.int64)
    L = torch.clamp(L, L_MIN, MAX_L)
    K = torch.clamp((L + 2) // 3, max=12)
    return gain, w0, L, K


def _per_frame_matvec(x: torch.Tensor, table: torch.Tensor,
                      li: torch.Tensor) -> torch.Tensor:
    """``out[f] = x[f] @ table[li[f]]`` in frame chunks, so the gathered
    ``[F, a, b]`` table stays under ``TILE_BYTES``."""
    F = x.shape[0]
    per = table.shape[1] * table.shape[2] * 4
    rows = max(1, TILE_BYTES // per)
    out = [torch.matmul(x[r:r + rows, None, :], table[li[r:r + rows]])[:, 0]
           for r in range(0, F, rows)]
    if not out:
        return x.new_zeros((0, table.shape[2]))
    return torch.cat(out)


def _transforms(S: torch.Tensor, tables):
    """``[F, 88]`` bits → (T ``[F, 56]``, ω0 ``[F]``, L, K)."""
    Sf = S.to(torch.float32)
    gain, w0, L, K = _headers(Sf, tables)
    li = L - L_MIN
    bits = torch.gather(Sf, 1, tables.dq_pos[li])            # [F, 70]
    codes = _per_frame_matvec(bits, tables.dq_w, li)          # [F, 55]
    x = (codes - tables.dq_offs[li]) * tables.dq_steps[li]
    G1 = tables.gain_min + gain * tables.gain_step
    coef = torch.cat([G1[:, None], x], dim=1)                 # [F, 56]
    T = _per_frame_matvec(coef, tables.dq_a, li)              # [F, 56]
    return T, w0, L, K


def prediction_scan_plain(T, w0, L, K, V, act, prev_logm, prev_L,
                          pred_decay: float, amp_scale: float):
    """The plain PyTorch version of K2: a loop over the ``T_n`` steps.
    Inputs ``[C, T_n, ...]``; returns (w0s, voiced, amps, f_logm, f_L)."""
    C, Tn = w0.shape
    dev = T.device
    lidx = torch.arange(1, MAX_L + 1, dtype=torch.float32, device=dev)[None]
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
        k0 = torch.minimum(torch.clamp(torch.floor(k).to(torch.int64), min=0),
                           kmax)
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


def prediction_scan(T, w0, L, K, V, act, prev_logm, prev_L,
                    pred_decay: float, amp_scale: float):
    """The inter-frame log-magnitude prediction over ``T_n`` steps of C
    channels: T ``[C, T_n, 56]`` f32, w0 ``[C, T_n]`` f32, L and K
    ``[C, T_n]`` int32, V ``[C, T_n, 12]`` f32, act ``[C, T_n]`` f32,
    prev_logm ``[C, 56]`` f32, prev_L ``[C]`` int32 → (w0s, voiced,
    amps, f_logm, f_L)."""
    if T.device.type == "cpu":
        return prediction_scan_plain(T, w0, L, K, V, act, prev_logm, prev_L,
                                     pred_decay, amp_scale)
    C, Tn = w0.shape
    for name, a, dt, shp in (
            ("T", T, torch.float32, (C, Tn, MAX_L)),
            ("w0", w0, torch.float32, (C, Tn)),
            ("L", L, torch.int32, (C, Tn)),
            ("K", K, torch.int32, (C, Tn)),
            ("V", V, torch.float32, (C, Tn, N_BANDS)),
            ("act", act, torch.float32, (C, Tn)),
            ("prev_logm", prev_logm, torch.float32, (C, MAX_L)),
            ("prev_L", prev_L, torch.int32, (C,))):
        kernels.require(a, name, dt, shp)
    lib = kernels.load()
    dev = T.device
    w0s = torch.empty((C, Tn), dtype=torch.float32, device=dev)
    voiced = torch.empty((C, Tn, MAX_L), dtype=torch.float32, device=dev)
    amps = torch.empty((C, Tn, MAX_L), dtype=torch.float32, device=dev)
    f_logm = torch.empty((C, MAX_L), dtype=torch.float32, device=dev)
    f_L = torch.empty((C,), dtype=torch.int32, device=dev)
    err = lib.dsd_imbe_pred(
        T.data_ptr(), w0.data_ptr(), L.data_ptr(), K.data_ptr(),
        V.data_ptr(), act.data_ptr(), prev_logm.data_ptr(),
        prev_L.data_ptr(), w0s.data_ptr(), voiced.data_ptr(),
        amps.data_ptr(), f_logm.data_ptr(), f_L.data_ptr(), C, Tn,
        pred_decay, amp_scale, kernels.stream_handle(T))
    kernels.check(err, "imbe_pred")
    prediction_scan.launches += 1
    return w0s, voiced, amps, f_logm, f_L


prediction_scan.launches = 0


def _b0_code(bits88: torch.Tensor, tables) -> torch.Tensor:
    """Raw 8-bit b0 code of each frame (int64)."""
    hi = bits88[:, tables.b0_hi_pos].to(torch.int64)
    b0 = (hi * _weights(8, hi.device)[:6]).sum(-1)
    lo0, lo1 = tables.b0_lo_pos
    return (b0 | (bits88[:, lo0].to(torch.int64) << 1)
            | bits88[:, lo1].to(torch.int64))


def imbe_frame_good(bits88: torch.Tensor, errs: torch.Tensor, tables):
    """1.0 for a voice frame the decoder uses (ECC errors ≤ 5 and a
    voice b0 code ≤ 207), else 0.0."""
    b0 = _b0_code(bits88, tables)
    return ((errs <= 5) & (b0 <= 207)).to(torch.float32)


def imbe_tone_params(bits88: torch.Tensor, tables):
    """In-band tone fields: (is_tone, ω0, amplitude) per frame."""
    b0 = _b0_code(bits88, tables)
    w7 = _weights(7, bits88.device)
    b = bits88.to(torch.int64)
    id1 = (b[:, 12:19] * w7).sum(-1)
    id2 = (b[:, 19:26] * w7).sum(-1)
    ad = (b[:, 26:33] * w7).sum(-1)
    is_tone = ((b0 >= tables.tone_b0_min) & (b0 <= tables.tone_b0_max)
               & (id1 == id2))
    w0_t = (2.0 * math.pi * TONE_FREQ_STEP_HZ / 8000.0) * id1.to(torch.float32)
    amp_t = ad.to(torch.float32) * (TONE_AMP_STEP / 8000.0)
    return is_tone, w0_t, amp_t


def repeat_state_init(C: int, device):
    """Repeat carry: (last-good w0, voiced, amps, repeats used, valid)."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(C), z(C, MAX_L), z(C, MAX_L),
            torch.zeros(C, dtype=torch.int32, device=device), z(C))


def synth_state_init(C: int, device):
    """Synthesis carry: (fundamental phase, last ω0, last amps)."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(C), z(C), z(C, MAX_L))


def repeat_gate(w0s, Vs, As, good, present, state,
                max_repeat: int = MAX_REPEAT):
    """The bounded frame-repeat contract on ``[C, T]`` parameter grids:
    a present-but-corrupt step re-uses the last good frame's parameters
    for up to ``max_repeat`` consecutive corrupt frames, then mutes;
    absent steps stay silent.  Parallel over steps: the last-good slot
    is a cummax over ``[C, T+1]`` whose slot 0 is the carried frame.
    Returns ((w0r, Vr, Ar), new state)."""
    C, T = w0s.shape
    Lh = Vs.shape[-1]
    dev = w0s.device
    lw0, lV, lA, rep_in, valid_in = state
    goode = torch.cat([valid_in[:, None] > 0, good > 0], dim=1)
    pb = present * (1.0 - good)
    pbe = torch.cat([rep_in.to(torch.float32)[:, None], pb], dim=1)
    pbcum = torch.cumsum(pbe, dim=1)                          # [C, T+1]
    sidx = torch.arange(T + 1, dtype=torch.int64, device=dev)[None]
    gidx = torch.cummax(torch.where(goode, sidx, -1), dim=1).values
    has = gidx >= 0
    gi = torch.clamp(gidx, min=0)
    reps = pbcum - torch.gather(pbcum, 1, gi)

    w0e = torch.cat([lw0[:, None], w0s], dim=1)
    Ve = torch.cat([lV[:, None], Vs], dim=1)
    Ae = torch.cat([lA[:, None], As], dim=1)
    use = ((good > 0) | ((present > 0) & has[:, 1:]
                         & (reps[:, 1:] <= max_repeat))).to(torch.float32)
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
    rep_o = torch.clamp(pbcum[:, -1] - torch.gather(pbcum, 1, glast)[:, 0],
                        0, max_repeat + 1).to(torch.int32)
    valid_o = has[:, -1].to(torch.float32)
    return (w0r, Vr, Ar), (lw0_o, lV_o, lA_o, rep_o, valid_o)


def voice_state_reset(state, channels):
    """Zero the carry rows of ``channels`` in a tuple of per-channel
    tensors (leading axis = channel); returns new tensors."""
    out = []
    for a in state:
        ch = torch.as_tensor(channels, dtype=torch.int64, device=a.device)
        out.append(a.index_fill(0, ch, 0))
    return tuple(out)


def noise_phases(C: int, n_steps: int, device) -> torch.Tensor:
    """The synthesizer's deterministic per-(channel, step, harmonic)
    phase table ``[C, n_steps, 56]``, as the JAX package builds it."""
    i = torch.arange(C * n_steps * MAX_L, dtype=torch.float32, device=device)
    return floor_mod(i * 2.399963, 2 * math.pi).reshape(C, n_steps, MAX_L)


class VoiceDecodeOut(NamedTuple):
    pcm: torch.Tensor       # wire format: f16 [C, T, 160], uint8 otherwise
    f_logm: torch.Tensor    # prediction carry [C, 56]
    f_L: torch.Tensor       # prediction carry [C]
    synth: tuple            # synthesis carry
    rep: tuple              # frame-repeat carry
    bits88: torch.Tensor    # [F, 88] decoded parameter bits of every frame
    errs: torch.Tensor      # [F] ECC error counts


def _decode_from_frames(frames144, fch, forder, prev_logm, prev_L,
                        C: int, n_steps: int, tables, pcm_fmt: str = "f16",
                        prev_synth=None, rep_state=None) -> VoiceDecodeOut:
    """``[F, 144]`` voice-frame bits with their channel / step indices
    (pad frames use channel C) → wire PCM and the new carries."""
    dev = frames144.device
    bits88, errs = imbe_ecc_batch(frames144, tables)
    T, w0, L, K = _transforms(bits88, tables)
    vs = tables.voicing_start
    V = bits88[:, vs:vs + N_BANDS].to(torch.float32)
    good = imbe_frame_good(bits88, errs, tables)

    def scat(vals, shape, dtype):
        z = torch.zeros((C + 1, n_steps) + shape, dtype=dtype, device=dev)
        z[fch, forder] = vals.to(dtype)     # duplicates only on pad row C
        return z[:C]

    Ts = scat(T, (MAX_L,), torch.float32)
    w0s = scat(w0, (), torch.float32)
    Ls = torch.clamp(scat(L, (), torch.int32), min=1)
    Ks = torch.clamp(scat(K, (), torch.int32), min=1)
    Vs = scat(V, (N_BANDS,), torch.float32)
    act = scat(good, (), torch.float32)

    w0o, voiced, amps, f_logm, f_L = prediction_scan(
        Ts, w0s, Ls, Ks, Vs, act, prev_logm, prev_L,
        tables.pred_decay, tables.imbe_amp_scale)

    # clean tone codes synthesize one harmonic; act=0 already froze the
    # prediction carry for them
    is_tone, w0_t, amp_t = imbe_tone_params(bits88, tables)
    tone_f = (is_tone & (errs <= 5)).to(torch.float32)
    tones = scat(tone_f, (), torch.float32)
    w0_ts = scat(w0_t * tone_f, (), torch.float32)
    amp_ts = scat(amp_t * tone_f, (), torch.float32)
    e0 = torch.zeros((1, 1, MAX_L), dtype=torch.float32, device=dev)
    e0[0, 0, 0] = 1.0
    ton = tones[:, :, None] > 0
    w0o = torch.where(tones > 0, w0_ts, w0o)
    voiced = torch.where(ton, e0, voiced)
    amps = torch.where(ton, e0 * (amp_ts * 0.5)[:, :, None], amps)

    present = scat(torch.ones_like(good), (), torch.float32)
    if rep_state is None:
        rep_state = repeat_state_init(C, dev)
    (w0o, voiced, amps), rep_out = repeat_gate(
        w0o, voiced, amps, torch.maximum(act, tones), present, rep_state)

    noise = noise_phases(C, n_steps, dev)
    if prev_synth is None:
        prev_synth = synth_state_init(C, dev)
    pcm, t_out, w_out, a_out = synthesize_stream(
        w0o, amps, voiced, noise, *prev_synth, tables=tables)
    wire = wire_encode(pcm, pcm_fmt, tables.adpcm_step, tables.adpcm_index)
    return VoiceDecodeOut(wire, f_logm, f_L, (t_out, w_out, a_out),
                          rep_out, bits88, errs)


def voice_decode_gather(dibits, ldu_ch, ldu_pos, offs, fch, forder,
                        prev_logm, prev_L, C: int, n_steps: int, tables,
                        pcm_fmt: str = "f16", prev_synth=None,
                        rep_state=None) -> VoiceDecodeOut:
    """The ``[C, T]`` dibits stay on the device: gather the 9 × 72-dibit
    voice frames of every accepted LDU (``offs`` = status-stripped
    offsets from the sync position; pad LDUs use ``ldu_ch == C``), then
    ECC → dequantization → prediction → synthesis → wire format."""
    Tn = dibits.shape[1]
    pos = torch.clamp(ldu_pos[:, None, None] + offs[None], 0, Tn - 1)
    ch = torch.clamp(ldu_ch, max=dibits.shape[0] - 1)
    dd = dibits[ch[:, None, None], pos].reshape(-1, 72)      # [Lp*9, 72]
    frames144 = torch.stack([(dd >> 1) & 1, dd & 1], dim=-1
                            ).reshape(-1, 144).to(torch.uint8)
    return _decode_from_frames(frames144, fch, forder, prev_logm, prev_L,
                               C, n_steps, tables, pcm_fmt,
                               prev_synth=prev_synth, rep_state=rep_state)
