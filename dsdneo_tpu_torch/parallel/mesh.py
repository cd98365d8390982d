"""Multi-GPU scaling: the channel axis sharded over the ranks of a mesh.

Counterpart of ``dsdneo_tpu/parallel/mesh.py``.  The decode is
parallel over channels, so each rank runs the same single-device program
on its own channels and nothing crosses ranks in the hot path; the only
collectives are the fleet metrics (``dist.all_mean`` for the JAX
``pmean`` of the mean power, ``dist.all_sum`` for the ``psum`` of CRC-ok
counts).  The mesh is ``parallel.dist.Mesh``: one process per GPU.

A JAX step takes the global array sharded over the mesh; a step here
takes the rank's local shard, ``[C / world, B, 2]`` float32 I/Q planes
(or ``[S / world, B, 2]`` bands and ``[S / world, R]`` row offsets for
the trunk step), and returns the rank's rows.  Each ``make_sharded_*``
returns ``(step, shard)`` as the JAX function returns ``(step,
sharding)``: ``shard(global_host_array)`` cuts the rank's rows and puts
them on its device (``dist.shard_rows``), and ``dist.gather_rows`` joins
the ranks' outputs in rank order.  A channel or system count that the
world size does not divide raises.

The per-shard bodies (``_p25_voice_body`` … ``_p25_cc_body``) are the
JAX bodies on one device, built for one ``[Cl, B]`` shape:

  - the front end (``engine.batched.frontend_step``: kernel K1 on the
    card; EDACS the gated front end, the analog rows no front end), the
    sync matched filter, and the ``K`` best positions per channel as a
    stable descending sort (equal scores keep the lower position first,
    as ``jax.lax.top_k`` does);
  - the family's gate on device (P25 NID and DUID, the DMR EMB
    confidence or the Golay(20,8) slot type, the NXDN LICH with the
    8-position shoulder mask, the P25p2 DUID and ISCH typing, the EDACS
    shoulder mask), invalid candidates routed to the drop row;
  - the family's device decode: ``voice_decode_gather`` (K2),
    ``dmr_voice_decode_gather``, ``nxdn_voice_decode_gather``,
    ``p2_voice_decode_gather``, ``p25_tsdu_decode_device`` (K4),
    ``dmr_csbk_decode_device``, ``nxdn_cac_decode_device`` (K5),
    ``edacs_cc_decode_device`` and ``analogbatch.analog_voice_decode``.

The voice bodies start from a fresh carry every call (the JAX bodies'
``pcast`` marks that state device-varying; here it is a fresh zero
state).  The PCM comes out as float32.  A voice body keeps its last
call's ``[Cl, K]`` valid mask in ``body.picks`` (a step's body is
``step.body``), the NXDN and EDACS CC bodies also the candidates' sync
positions in ``body.positions``, for checks.  Tables come from the port's
``params`` loaders on the rank's device.
"""

from __future__ import annotations

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.engine.batched import frontend_step
from dsdneo_tpu_torch.engine.ccbatch import (DMR_BURST_EXTENT,
                                            dmr_csbk_decode_device,
                                            edacs_cc_decode_device,
                                            nxdn_cac_decode_device,
                                            p25_tsdu_decode_device)
from dsdneo_tpu_torch.engine.dmrbatch import (EMB_DIBITS, SF_EXTENT,
                                              SF_PERIOD, _sf_frame_offsets,
                                              dmr_voice_decode_gather)
from dsdneo_tpu_torch.engine.modes import MODES
from dsdneo_tpu_torch.engine.voicebatch import (LDU_DATA_DIBITS,
                                                LDU_IMBE_OFFSETS,
                                                _status_strip_map,
                                                correlate_syncs_device)
from dsdneo_tpu_torch.parallel import dist as pdist
from dsdneo_tpu_torch.symbols.framesync import sync_levels
from dsdneo_tpu_torch.vocoder.device import voice_decode_gather


# -- shared pieces ------------------------------------------------------------
def _top_k(bs: torch.Tensor, K: int):
    """``jax.lax.top_k`` along the last axis: the K largest, best first,
    equal scores in position order."""
    vals, idx = torch.sort(bs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _levels(names, device) -> torch.Tensor:
    """The named sync rows, in the table's order (``_sync_kernel``)."""
    return torch.as_tensor(sync_levels(names), device=device)


def _taps(mode_name: str, fs: float, device) -> torch.Tensor:
    """The mode's channel filter at ``fs``."""
    return torch.as_tensor(firdes.channel_lpf(fs, MODES[mode_name]
                                              .lpf_profile), device=device)


def _check(iq: torch.Tensor, Cl: int, B: int) -> None:
    if tuple(iq.shape[:2]) != (Cl, B):
        raise ValueError(f"body built for [{Cl}, {B}], got "
                         f"{list(iq.shape[:2])}")


def _bits(dd: torch.Tensor) -> torch.Tensor:
    """``[..., n]`` dibits → ``[..., 2n]`` int64 bits, high bit first."""
    d = dd.to(torch.int64)
    return torch.stack([(d >> 1) & 1, d & 1], dim=-1
                       ).reshape(*dd.shape[:-1], -1)


def _frame_maps(Cl: int, K: int, n: int, device):
    """The fixed-capacity frame layout: each channel's K candidates of
    ``n`` frames, in (channel, candidate, frame) order → (frame channel
    base ``[Cl·K·n]``, frame order ``[Cl·K·n]``)."""
    fch = np.repeat(np.arange(Cl * K) // K, n)
    forder = np.tile(np.repeat(np.arange(K), n) * n + np.tile(np.arange(n),
                                                              K), Cl)
    return (torch.as_tensor(fch, dtype=torch.int64, device=device),
            torch.as_tensor(forder, dtype=torch.int64, device=device))


def _topk_shoulder_mask(idx: torch.Tensor, stride: int = 8) -> torch.Tensor:
    """``[..., K]`` top-k positions (best first) → ``[..., K]`` bool mask
    of shoulder candidates: candidate k within ``stride`` positions of a
    better candidate j < k.  Only an 8-position shoulder, as in the JAX
    package, whose blobs the port is held to."""
    K = idx.shape[-1]
    d = (idx[..., :, None] - idx[..., None, :]).abs()          # [..., k, j]
    earlier = torch.ones((K, K), dtype=torch.bool,
                         device=idx.device).tril(-1)           # j < k
    return ((d < stride) & earlier).any(dim=-1)


# -- the front end alone ------------------------------------------------------
def make_sharded_frontend(mesh: pdist.Mesh, mode_name: str, C: int, B: int,
                          fs: float = 48000.0):
    """The front end over the rank's ``[C / world, B, 2]`` channels →
    (dibits, soft symbols, power ``[Cl]``, fleet mean power on every
    rank).  Returns (step, shard)."""
    Cl = mesh.local_count(C)
    mode = MODES[mode_name]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps(mode_name, fs, mesh.device)

    def step(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        return dibits, soft, power, pdist.all_mean(mesh, power.mean())

    return step, lambda x: pdist.shard_rows(mesh, x)


def _sharded(mesh: pdist.Mesh, body, keep: int, reduce):
    """A step of ``body`` over the rank's channels: its first ``keep``
    outputs and the fleet metric ``reduce(outputs)`` over the mesh."""

    def step(iq: torch.Tensor):
        out = body(iq)
        return (*out[:keep], reduce(out))

    step.body = body
    return step, lambda x: pdist.shard_rows(mesh, x)


# -- P25 Phase 1 voice --------------------------------------------------------
def _p25_voice_body(Cl: int, B: int, fs: float = 48000.0,
                    max_ldus: int = 2, sync_threshold: float = 0.62, *,
                    tables: params.P25Tables):
    """The P25p1 voice chain for ``[Cl, B, 2]`` I/Q planes on ``tables``'
    device → (``[Cl, max_ldus·9·160]`` float32 PCM, ``[Cl]`` power):
    the front end (K1), the ``max_ldus`` best sync positions, the NID as
    a BCH(63,16) codebook argmax, valid = score ∧ DUID 5/10 ∧ upright ∧
    the LDU inside the block, then ``voice_decode_gather`` (K2) from a
    fresh prediction state."""
    t = tables
    dev = t.taps.device
    sps = fs / t.symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps("p25p1", fs, dev)
    levels = _levels(("+P25p1", "-P25p1"), dev)
    n_pat = levels.shape[1]
    nid_strip = torch.as_tensor(_status_strip_map(n_pat, 32), device=dev)
    strip = _status_strip_map(n_pat, 32 + LDU_DATA_DIBITS)
    frame_offs = torch.as_tensor(np.stack(
        [strip[32 + o:32 + o + 72] for o in LDU_IMBE_OFFSETS]), device=dev)
    need = int(strip[-1]) + 1
    pm_t = t.bch_pm.T
    K = max_ldus
    fch_base, forder = _frame_maps(Cl, K, 9, dev)
    rows = torch.arange(Cl, device=dev)

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            t.four_level)
        sc = correlate_syncs_device(soft, levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)            # [Cl, K]
        gpos = torch.clamp(idx[:, :, None] + nid_strip, 0,
                           dibits.shape[1] - 1)
        b64 = _bits(dibits[rows[:, None, None], gpos])          # [Cl, K, 64]
        s = 1.0 - 2.0 * b64[..., :63].to(torch.float32)
        msg = torch.argmax(s.reshape(-1, 63) @ pm_t, dim=-1).reshape(Cl, K)
        duid = msg & 0xF
        inv = torch.gather(best_def, 1, idx) & 1
        valid = ((vals >= sync_threshold) & ((duid == 5) | (duid == 10))
                 & (inv == 0) & (idx + need < n_sym))
        ldu_ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        # invalid candidates scatter to the drop row
        fch = torch.where(valid.reshape(-1).repeat_interleave(9), fch_base,
                          Cl)
        prev_logm = torch.zeros((Cl, 56), dtype=torch.float32, device=dev)
        prev_L = torch.zeros(Cl, dtype=torch.int32, device=dev)
        body.picks = valid
        out = voice_decode_gather(dibits, ldu_ch, idx.reshape(-1),
                                  frame_offs, fch, forder, prev_logm, prev_L,
                                  Cl, K * 9, t)
        return out.pcm.to(torch.float32).reshape(Cl, -1), power

    return body


def make_sharded_voice_step(mesh: pdist.Mesh, C: int, B: int,
                            fs: float = 48000.0, max_ldus: int = 2,
                            sync_threshold: float = 0.62, *, tables=None):
    """The P25p1 voice chain over the rank's channels: ``[C / world, B,
    2]`` I/Q → (``[Cl, max_ldus·9·160]`` PCM, fleet mean power).
    Returns (step, shard)."""
    Cl = mesh.local_count(C)
    t = tables if tables is not None else params.load(mesh.device)
    body = _p25_voice_body(Cl, B, fs, max_ldus, sync_threshold, tables=t)
    return _sharded(mesh, body, 1,
                    lambda out: pdist.all_mean(mesh, out[1].mean()))


# -- DMR BS voice -------------------------------------------------------------
def _dmr_voice_body(Cl: int, B: int, fs: float = 48000.0, max_sf: int = 2,
                    sync_threshold: float = 0.62, *,
                    tables: params.DmrTables):
    """The DMR BS voice chain → (``[Cl, max_sf·18·160]`` float32 PCM,
    ``[Cl]`` power): the ``max_sf`` best voice-sync positions, valid =
    score ∧ the VC2 + VC3 EMB words within 2 summed QR(16,7,6) bit errors
    ∧ the superframe inside the block, then
    ``dmr_voice_decode_gather``."""
    t = tables
    dev = t.taps.device
    sps = fs / t.symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps("dmr", fs, dev)
    levels = _levels(("+DMR BS voice", "-DMR BS voice"), dev)
    offs = torch.as_tensor(_sf_frame_offsets().astype(np.int64), device=dev)
    offs16 = torch.as_tensor(EMB_DIBITS, dtype=torch.int64, device=dev)
    K = max_sf
    fch_base, forder = _frame_maps(Cl, K, 18, dev)
    rows = torch.arange(Cl, device=dev)

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            t.four_level)
        sc = correlate_syncs_device(soft, levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)
        inv = torch.gather(best_def, 1, idx) & 1
        Tn = dibits.shape[1]
        errs_tot = torch.zeros(idx.shape, dtype=torch.int64, device=dev)
        for burst in (1, 2):
            base = torch.clamp(idx + SF_PERIOD * burst, 0, Tn - 25)
            dd = dibits[rows[:, None, None], base[:, :, None] + offs16]
            dd = dd.to(torch.int64) ^ (inv[:, :, None] * 2)
            b16 = _bits(dd)                                     # [Cl, K, 16]
            s = 1.0 - 2.0 * b16.to(torch.float32)
            m = torch.argmax(s @ t.qr_pm.T, dim=-1)
            errs_tot += (t.qr_cb[m].to(torch.int64) != b16).sum(dim=-1)
        valid = ((vals >= sync_threshold) & (errs_tot <= 2) & (idx >= 54)
                 & (idx + SF_EXTENT < n_sym))
        sf_ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        # invalid candidates scatter to the drop row: their gathered
        # dibits are arbitrary and must not synthesize phantom audio
        fch = torch.where(valid.reshape(-1).repeat_interleave(18), fch_base,
                          Cl)
        body.picks = valid
        out = dmr_voice_decode_gather(dibits, sf_ch, idx.reshape(-1),
                                      inv.reshape(-1), offs, fch, forder, Cl,
                                      K * 18, t)
        return out.pcm.to(torch.float32).reshape(Cl, -1), power

    return body


def make_sharded_dmr_voice_step(mesh: pdist.Mesh, C: int, B: int,
                                fs: float = 48000.0, max_sf: int = 2,
                                sync_threshold: float = 0.62, *,
                                tables=None):
    """The DMR BS voice chain over the rank's channels: ``[C / world, B,
    2]`` I/Q → (``[Cl, max_sf·18·160]`` PCM, fleet mean power).  Returns
    (step, shard)."""
    Cl = mesh.local_count(C)
    t = tables if tables is not None else params.load_dmr(mesh.device)
    body = _dmr_voice_body(Cl, B, fs, max_sf, sync_threshold, tables=t)
    return _sharded(mesh, body, 1,
                    lambda out: pdist.all_mean(mesh, out[1].mean()))


# -- DMR Tier III control channel ---------------------------------------------
def _dmr_cc_body(Cl: int, B: int, fs: float = 48000.0, max_csbks: int = 8,
                 sync_threshold: float = 0.62, *, tables: params.CcTables):
    """DMR TSCC monitoring → (``[Cl, max_csbks, 14]`` uint8 CSBK blobs
    (12 payload bytes, the CRC-ok byte, the BPTC error count),
    ``[Cl, max_csbks]`` valid, ``[Cl, max_csbks]`` int32 colour code):
    the data-sync candidates' Golay(20,8) slot type as a codebook
    argmax, valid = score ∧ ≤ 2 Golay errors ∧ data type 3 (CSBK) ∧ the
    burst inside the block.  Shoulder duplicates survive the mask; the
    host parse cache collapses them."""
    cc = tables
    dev = cc.front.taps.device
    sps = fs / cc.front.symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps("dmr", fs, dev)
    # "+DMR BS voice" is the inverted data sync
    levels = _levels(("+DMR BS data", "+DMR BS voice"), dev)
    K = max_csbks
    rows = torch.arange(Cl, device=dev)

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, _power = frontend_step(iq, taps, sps, n_sym,
                                             cc.front.four_level)
        sc = correlate_syncs_device(soft, levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)
        inv = torch.gather(best_def, 1, idx) & 1
        Tn = dibits.shape[1]
        gp = torch.clamp(idx[:, :, None] + cc.dmr_st_offs, 0, Tn - 1)
        dd = dibits[rows[:, None, None], gp].to(torch.int64) \
            ^ (inv[:, :, None] * 2)
        b20 = _bits(dd)                                         # [Cl, K, 20]
        s = 1.0 - 2.0 * b20.to(torch.float32)
        m = torch.argmax(s @ cc.golay20_pm.T, dim=-1)
        errs = (cc.golay20_cb[m].to(torch.int64) != b20).sum(dim=-1)
        dtype = m & 0xF
        cc4 = (m >> 4) & 0xF
        valid = ((vals >= sync_threshold) & (errs <= 2) & (dtype == 3)
                 & (idx >= 54) & (idx + DMR_BURST_EXTENT < n_sym))
        ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        blob = dmr_csbk_decode_device(dibits, ch, idx.reshape(-1),
                                      inv.reshape(-1), cc)
        return blob.reshape(Cl, K, -1), valid, cc4.to(torch.int32)

    return body


# -- NXDN voice and control channel -------------------------------------------
def _nxdn_lich(dibits, idx, inv, lich_flip, w8, rows):
    """Every candidate's LICH byte: the 8 dibits after the FSW,
    descrambled and polarity-corrected, the high bit of each."""
    Tn = dibits.shape[1]
    gp = torch.clamp(idx[:, :, None] + 10
                     + torch.arange(8, device=dibits.device), 0, Tn - 1)
    dd = dibits[rows[:, None, None], gp].to(torch.int64) \
        ^ (inv[:, :, None] * 2) ^ lich_flip
    return (((dd >> 1) & 1) * w8).sum(dim=-1)                  # [Cl, K]


def _lich_consts(pn9: np.ndarray, device):
    """(the LICH dibits' descramble flips, the bit weights of its byte)."""
    lich_flip = torch.as_tensor(np.isin(np.arange(8), pn9).astype(np.int64)
                                * 2, device=device)
    w8 = torch.tensor([1 << (7 - i) for i in range(8)], device=device)
    return lich_flip, w8


def _nxdn_voice_body(Cl: int, B: int, fs: float = 48000.0,
                     max_frames: int = 4, sync_threshold: float = 0.55,
                     mode_name: str = "nxdn48", *,
                     tables: params.TdmaTables):
    """The NXDN voice chain → (``[Cl, max_frames·4·160]`` float32 PCM,
    ``[Cl]`` power): the ``max_frames`` best FSW positions, valid = score
    ∧ a parity-valid full-voice LICH ∧ not a shoulder ∧ the frame inside
    the block, then ``nxdn_voice_decode_gather``."""
    from dsdneo_tpu_torch.engine.nxdnbatch import (FRAME_DIBITS,
                                                   _LICH_FULL_VOICE_LUT,
                                                   _voice_tables,
                                                   nxdn_voice_decode_gather)
    t = tables
    dev = t.taps.device
    sps = fs / MODES[mode_name].symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps(mode_name, fs, dev)
    levels = _levels(("+NXDN FSW", "-NXDN FSW"), dev)
    pn9 = t.np["nxdn_pn9_positions"]
    lich_flip, w8 = _lich_consts(pn9, dev)
    o, f = _voice_tables(pn9)
    offs = torch.as_tensor(o, device=dev)
    flips = torch.as_tensor(f, device=dev)
    lut = torch.as_tensor(_LICH_FULL_VOICE_LUT, device=dev)
    K = max_frames
    fch_base, forder = _frame_maps(Cl, K, 4, dev)
    rows = torch.arange(Cl, device=dev)
    four_level = MODES[mode_name].four_level

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym, four_level)
        sc = correlate_syncs_device(soft, levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)
        inv = torch.gather(best_def, 1, idx) & 1
        lich = _nxdn_lich(dibits, idx, inv, lich_flip, w8, rows)
        valid = ((vals >= sync_threshold) & lut[lich]
                 & ~_topk_shoulder_mask(idx) & (idx + FRAME_DIBITS < n_sym))
        f_ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        fch = torch.where(valid.reshape(-1).repeat_interleave(4), fch_base,
                          Cl)
        body.picks = valid
        out = nxdn_voice_decode_gather(dibits, f_ch, idx.reshape(-1),
                                       inv.reshape(-1), offs, flips, fch,
                                       forder, Cl, K * 4, t)
        return out.pcm.to(torch.float32).reshape(Cl, -1), power

    return body


def _nxdn_cc_body(Cl: int, B: int, fs: float = 48000.0, max_cacs: int = 8,
                  sync_threshold: float = 0.55, mode_name: str = "nxdn48", *,
                  tables: params.CcTables):
    """NXDN Type-C RCCH monitoring → (``[Cl, max_cacs, 23]`` uint8 CAC
    blobs (22 packed payload bytes, the CRC-ok byte), ``[Cl, max_cacs]``
    valid, ``[Cl, max_cacs]`` int32 LICH): valid = score ∧ a
    parity-valid CAC-profile LICH ∧ upright ∧ not a shoulder ∧ the frame
    inside the block, then ``nxdn_cac_decode_device`` (K5)."""
    from dsdneo_tpu_torch.engine.nxdnbatch import (FRAME_DIBITS,
                                                   _lich_parity_ok)
    cc = tables
    dev = cc.front.taps.device
    sps = fs / MODES[mode_name].symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps(mode_name, fs, dev)
    levels = _levels(("+NXDN FSW", "-NXDN FSW"), dev)
    lich_flip, w8 = _lich_consts(cc.front.np["nxdn_pn9_positions"], dev)
    # parity-valid AND CAC-bearing (the monitor's _CAC_LICH), over all
    # 256 LICH byte values
    lut = torch.as_tensor([_lich_parity_ok(v) and (v >> 1) in (0x01, 0x05)
                           for v in range(256)], device=dev)
    K = max_cacs
    rows = torch.arange(Cl, device=dev)
    four_level = MODES[mode_name].four_level

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, _power = frontend_step(iq, taps, sps, n_sym,
                                             four_level)
        sc = correlate_syncs_device(soft, levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)
        inv = torch.gather(best_def, 1, idx) & 1
        lich = _nxdn_lich(dibits, idx, inv, lich_flip, w8, rows)
        valid = ((vals >= sync_threshold) & lut[lich]
                 & (inv == 0)      # the CAC decode gathers upright dibits
                 & ~_topk_shoulder_mask(idx) & (idx + FRAME_DIBITS < n_sym))
        ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        body.picks, body.positions = valid, idx
        blob = nxdn_cac_decode_device(dibits, ch, idx.reshape(-1), cc)
        return blob.reshape(Cl, K, -1), valid, lich.to(torch.int32)

    return body


# -- EDACS control channel and analog voice -----------------------------------
def _edacs_cc_body(Cl: int, B: int, fs: float = 48000.0, max_frames: int = 8,
                   sync_threshold: float = 0.62, *, device):
    """EDACS CC monitoring on ``device`` → (``[Cl, max_frames, 12]``
    uint8 blobs (msg1, msg2, ok, inverted, pad), ``[Cl, max_frames]``
    valid, ``[Cl, max_frames]`` int32 polarity): the power-gated front
    end, the ``max_frames`` best sync positions, valid = score ∧ not a
    shoulder ∧ the frame inside the block, then the dual-polarity 2-of-3
    vote and BCH(40,28) screen of ``edacs_cc_decode_device``."""
    from dsdneo_tpu_torch.engine.demod import gated_frontend_step
    dev = torch.empty(0, device=device).device
    mode = MODES["edacs"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps("edacs", fs, dev)
    levels = _levels(("+EDACS", "-EDACS"), dev)
    n_pat = levels.shape[1]
    K = max_frames
    rows = torch.arange(Cl, device=dev)

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft = gated_frontend_step(iq, taps, sps, n_sym,
                                           mode.four_level)
        sc = correlate_syncs_device(torch.clamp(soft, -3.5, 3.5), levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)
        valid = ((vals >= sync_threshold) & ~_topk_shoulder_mask(idx)
                 & (idx + n_pat + 240 < n_sym))
        ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        body.picks, body.positions = valid, idx
        blob = edacs_cc_decode_device(dibits, ch, (idx + n_pat).reshape(-1))
        inv = torch.gather(best_def, 1, idx)
        return blob.reshape(Cl, K, -1), valid, inv.to(torch.int32)

    return body


def _analog_voice_body(fs: float = 48000.0):
    """The analog NBFM voice chain (EDACS working channels): ``[Cl, B,
    2]`` I/Q → (``[Cl, B // 6]`` 8 kHz float32 PCM, ``[Cl]`` power)."""
    from dsdneo_tpu_torch.engine.analogbatch import analog_voice_decode

    def body(iq: torch.Tensor):
        power = torch.mean(iq.to(torch.float32) ** 2, dim=(1, 2))
        return analog_voice_decode(iq, fs=fs), power

    return body


# -- P25 Phase 2 TDMA voice ---------------------------------------------------
def _p2_voice_body(Cl: int, B: int, fs: float = 48000.0,
                   max_frames: int = 2, wacn: int = 0xBEE00,
                   sysid: int = 0x14C, nac: int = 0x140,
                   sync_threshold: float = 0.62, *,
                   tables: params.TdmaTables):
    """The P25p2 clear-voice chain → (``[2·Cl, max_frames·8·160]``
    float32 per-slot PCM, ``[Cl]`` power): the ``max_frames`` best sync
    positions; each candidate's four timeslots typed by the nearest DUID
    codeword and its superframe row read from the TS0 ISCH location word
    (nearest of the 128 ISCH codewords); 4V timeslots of valid
    candidates go to ``p2_voice_decode_gather`` with the static scramble
    table of (wacn, sysid, nac)."""
    from dsdneo_tpu_torch.engine.p2batch import (DUID_DIBITS, FRAME_DIBITS,
                                                 ISCH_DIBIT0, SCRAMBLE_BITS,
                                                 TS_DIBITS,
                                                 p2_voice_decode_gather)
    from dsdneo_tpu_torch.protocol.p25 import p2_xcch
    from dsdneo_tpu_torch.protocol.p25.phase2 import DUID_CANONICAL
    t = tables
    dev = t.taps.device
    C2 = 2 * Cl
    sps = fs / MODES["p25p2"].symbol_rate
    n_sym = int(B // sps) - 2
    taps = _taps("p25p2", fs, dev)
    levels = _levels(("+P25p2",), dev)
    n_pat = levels.shape[1]
    scr_tab = torch.as_tensor(p2_xcch.generate_scramble_bits(
        wacn, sysid, nac, SCRAMBLE_BITS).astype(np.uint8), device=dev)
    isch_items = sorted((p2_xcch.isch_codeword(v), v) for v in range(128))
    isch_pm = torch.as_tensor(np.array(
        [[1.0 - 2.0 * ((w >> (39 - i)) & 1) for i in range(40)]
         for w, _v in isch_items], np.float32), device=dev)
    isch_vals = torch.as_tensor([v for _w, v in isch_items], device=dev)
    duid_pm = torch.as_tensor(np.array(
        [[1.0 - 2.0 * ((c >> (7 - i)) & 1) for i in range(8)]
         for c in DUID_CANONICAL], np.float32), device=dev)
    K = max_frames
    # static per-frame maps: K candidates × 4 TS × 4 frames per channel,
    # in (channel, candidate, TS, frame) order; slot s collects 8 frames
    # per candidate (2 TS × 4)
    ts_n = np.tile(np.repeat(np.arange(4), 4), Cl * K)
    off_n = np.tile(np.arange(4), Cl * K * 4)
    cand_n = np.tile(np.repeat(np.arange(K), 16), Cl)
    ch_n = np.repeat(np.arange(Cl), K * 16)
    on = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)  # noqa
    ts_i, ch_i = on(ts_n), on(ch_n)
    f_offidx = on(off_n)
    f_ord = on(cand_n * 8 + (ts_n // 2) * 4 + off_n)
    duid_idx = on((ch_n * K + cand_n) * 4 + ts_n)
    duid_offs = torch.as_tensor(n_pat + TS_DIBITS * np.arange(4)[:, None]
                                + DUID_DIBITS[None], device=dev)   # [4, 4]
    isch_offs = torch.as_tensor(n_pat + ISCH_DIBIT0 + np.arange(20),
                                device=dev)
    rows = torch.arange(Cl, device=dev)

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            t.four_level)
        sc = correlate_syncs_device(soft, levels)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)
        Tn = dibits.shape[1]
        # DUID per TS: 4 dibits → 8 bits, nearest of the 16 codewords
        gp_d = torch.clamp(idx[:, :, None, None] + duid_offs, 0, Tn - 1)
        b8 = _bits(dibits[rows[:, None, None, None], gp_d])  # [Cl, K, 4, 8]
        duid = torch.argmax((1.0 - 2.0 * b8.to(torch.float32)) @ duid_pm.T,
                            dim=-1)                           # [Cl, K, 4]
        # TS0 ISCH → superframe row (location words only)
        gp_i = torch.clamp(idx[:, :, None] + isch_offs, 0, Tn - 1)
        b40 = _bits(dibits[rows[:, None, None], gp_i])       # [Cl, K, 40]
        mi = torch.argmax((1.0 - 2.0 * b40.to(torch.float32)) @ isch_pm.T,
                          dim=-1)
        v = isch_vals[mi]
        sfv = (v >> 3) & 3
        loc_ok = (((v >> 5) & 3) == 1) & (sfv <= 2)
        row0 = sfv * 4                                        # TS0 row
        cand_ok = ((vals >= sync_threshold) & loc_ok
                   & (idx + FRAME_DIBITS < n_sym))
        # per-frame arrays [Cl·K·16]
        voice4 = duid.reshape(-1)[duid_idx] == 0              # 4V timeslots
        ok_f = cand_ok.reshape(-1).repeat_interleave(16) & voice4
        f_ch = torch.where(ok_f, ch_i, Cl)
        tpos = idx.reshape(-1).repeat_interleave(16) + n_pat + TS_DIBITS * ts_i
        f_row = (row0.reshape(-1).repeat_interleave(16) + ts_i) % 12
        f_out = torch.where(ok_f, 2 * ch_i + ts_i % 2, C2)
        body.picks = cand_ok
        ks = torch.zeros((f_ch.shape[0], 7), dtype=torch.uint8, device=dev)
        out = p2_voice_decode_gather(dibits, scr_tab, f_ch, tpos, f_row,
                                     f_offidx, f_out, f_ord, ks, C2, K * 8, t)
        return out.pcm.to(torch.float32).reshape(C2, -1), power

    return body


def make_sharded_p2_voice_step(mesh: pdist.Mesh, C: int, B: int,
                               fs: float = 48000.0, max_frames: int = 2,
                               wacn: int = 0xBEE00, sysid: int = 0x14C,
                               nac: int = 0x140,
                               sync_threshold: float = 0.62, *,
                               tables=None):
    """The P25p2 voice chain over the rank's channels: ``[C / world, B,
    2]`` I/Q → (``[2·Cl, max_frames·8·160]`` per-slot PCM, fleet mean
    power).  Returns (step, shard)."""
    Cl = mesh.local_count(C)
    t = tables if tables is not None else params.load_tdma("p25p2",
                                                            mesh.device)
    body = _p2_voice_body(Cl, B, fs, max_frames, wacn, sysid, nac,
                          sync_threshold, tables=t)
    return _sharded(mesh, body, 1,
                    lambda out: pdist.all_mean(mesh, out[1].mean()))


# -- P25 Phase 1 control channel ----------------------------------------------
def _p25_cc_body(Cl: int, B: int, fs: float = 48000.0,
                 max_tsdus: int = 4, sync_threshold: float = 0.62,
                 nac_out: bool = False, dedup: bool = False, *,
                 tables: params.CcTables):
    """The device TSDU pick for ``[Cl, B, 2]`` float32 I/Q planes on
    ``tables``' device → (``[Cl, max_tsdus, 114]`` uint8 TSDU blobs,
    ``[Cl, max_tsdus]`` valid mask[, ``[Cl, max_tsdus]`` NID
    messages]): the front end (K1), the ``max_tsdus`` best positions, the
    BCH(63,16) NID as a codebook argmax, valid = score ∧ DUID 7 ∧
    upright ∧ the TSDU inside the block (∧ not a shoulder with
    ``dedup``), and the TSBK trellis decode of every candidate (K4).
    Blob layout: 3 × (12 payload bytes, the CRC-ok byte, 25 bytes of raw
    dibits).  The single-device fleet's ``cc_device_pick`` runs it
    too."""
    t = tables.front
    sps = fs / t.symbol_rate
    n_sym = int(B // sps) - 2
    n_pat = t.sync_len
    dev = t.taps.device
    nid_strip = torch.as_tensor(_status_strip_map(n_pat, 32), device=dev)
    need = int(_status_strip_map(n_pat, 32 + 294)[-1]) + 1
    pm_t = t.bch_pm.T                                      # [63, 65536]
    K = max_tsdus
    rows = torch.arange(Cl, device=dev)

    def body(iq: torch.Tensor):
        _check(iq, Cl, B)
        dibits, soft, _power = frontend_step(iq, t.taps, sps, n_sym,
                                             t.four_level)
        sc = correlate_syncs_device(soft, t.sync_levels)
        best_def = torch.argmax(sc, dim=1)
        vals, idx = _top_k(torch.amax(sc, dim=1), K)           # [Cl, K]
        gpos = torch.clamp(idx[:, :, None] + nid_strip, 0,
                           dibits.shape[1] - 1)
        b64 = _bits(dibits[rows[:, None, None], gpos])
        s = 1.0 - 2.0 * b64[..., :63].to(torch.float32)
        msg = torch.argmax(s.reshape(-1, 63) @ pm_t, dim=-1
                           ).reshape(Cl, K).to(torch.int32)
        duid = msg & 0xF
        inv = torch.gather(best_def, 1, idx) & 1
        valid = ((vals >= sync_threshold) & (duid == 7) & (inv == 0)
                 & (idx + need < n_sym))
        if dedup:
            # shoulder suppression frees fixed-capacity slots for
            # distinct TSDUs when K is tight
            valid = valid & ~_topk_shoulder_mask(idx)
        ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        blob = p25_tsdu_decode_device(dibits, ch, idx.reshape(-1), tables)
        blob = blob.reshape(Cl, K, -1)
        if nac_out:
            return blob, valid, msg
        return blob, valid

    return body


def _ok_count(blob, valid, cols) -> torch.Tensor:
    """CRC-ok bytes ``cols`` of every valid candidate, summed."""
    ok = sum(blob[..., c].to(torch.int64) for c in cols)
    return (ok * valid.to(torch.int64)).sum()


def make_sharded_p25_cc_step(mesh: pdist.Mesh, C: int, B: int,
                             fs: float = 48000.0, max_tsdus: int = 4,
                             sync_threshold: float = 0.62, *, tables=None):
    """P25p1 control-channel monitoring over the rank's channels:
    ``[C / world, B, 2]`` I/Q → (``[Cl, max_tsdus, 114]`` TSDU blobs,
    ``[Cl, max_tsdus]`` valid, the fleet's CRC-ok TSBK count over all
    ranks).  The host parses the blobs outside the step.  Returns (step,
    shard)."""
    Cl = mesh.local_count(C)
    t = tables if tables is not None else params.load_cc("p25", mesh.device)
    body = _p25_cc_body(Cl, B, fs, max_tsdus, sync_threshold, tables=t)
    return _sharded(mesh, body, 2, lambda out: pdist.all_sum(
        mesh, _ok_count(out[0], out[1], (12, 50, 88))))


# -- closed-loop trunking over systems ----------------------------------------
TRUNK_MODES = ("p25p1", "dmr", "nxdn48", "nxdn96", "edacs", "p25_mixed")


def row_samples(B: int, n_ch: int) -> int:
    """The 48 kHz row length the extractor gives a wideband block of
    ``B`` samples over ``n_ch`` bank channels (the bank's 2m samples
    halved by the decimator)."""
    return (B - n_ch // 2) // n_ch


def make_sharded_trunk_step(mesh: pdist.Mesh, S: int, fs: float, B: int,
                            n_cc: int = 1, n_vc: int = 2,
                            max_tsdus: int = 4, max_ldus: int = 2,
                            sync_threshold: float = 0.62,
                            trunk_mode: str = "p25p1", p2_params=None):
    """Closed-loop trunking of S systems (one wideband stream each)
    sharded over the ranks: each rank extracts its systems' rows
    (``engine.fleettrunk.make_row_extractor_body`` on each), runs the
    family's CC body over every CC row and its voice body over every
    voice row.  The row offsets are a data input, so the host can point a
    voice row at a grant between steps with nothing rebuilt.

    ``trunk_mode``: ``"p25p1"`` (TSBK CC, LDU voice), ``"dmr"`` (CSBK
    TSCC, AMBE superframes), ``"nxdn48"`` / ``"nxdn96"`` (CAC RCCH, AMBE
    full-voice frames), ``"edacs"`` (BCH CC, analog NBFM rows) or
    ``"p25_mixed"`` (TSBK CC granting TDMA channels, decoded by the
    Phase 2 body, two PCM rows per voice row; needs ``p2_params=(wacn,
    sysid, nac)``: the body's scramble table is built once).

    The step maps (local bands ``[S / world, B, 2]`` float32 planes,
    uint8 CU8 planes or ``[S / world, B]`` complex; offsets ``[S /
    world, n_cc + n_vc]`` int32 Hz from each band's centre) → (CC blobs
    ``[Sl, n_cc, K, W]`` uint8 (W = 114 TSDU, 14 CSBK, 23 CAC, 12
    EDACS), valid ``[Sl, n_cc, K]``, meta ``[Sl, n_cc, K]`` int32 (P25
    the NID message, DMR the colour code, NXDN the LICH, EDACS the
    polarity), PCM ``[Sl, R_v, T]`` float32 (R_v = n_vc, 2·n_vc for
    ``p25_mixed``), the fleet's CRC-ok count over all ranks).  Returns
    (step, (band shard, offset shard))."""
    from dsdneo_tpu_torch.engine.fleettrunk import (CHANNEL_RATE,
                                                    make_row_extractor_body)
    Sl = mesh.local_count(S, "system")
    n_ch = int(round(fs / CHANNEL_RATE))
    if abs(fs - n_ch * CHANNEL_RATE) > 1.0 or n_ch < 2:
        raise ValueError(f"fs {fs:g} must be a ≥2 multiple of 48 kHz")
    if trunk_mode not in TRUNK_MODES:
        raise ValueError("trunk_mode must be 'p25p1', 'dmr', 'nxdn48', "
                         "'nxdn96', 'edacs', or 'p25_mixed' "
                         f"(got {trunk_mode!r})")
    dev = mesh.device
    extract = make_row_extractor_body(n_ch)
    Bp = row_samples(B, n_ch)
    vc_rows = n_vc
    if trunk_mode in ("p25p1", "p25_mixed"):
        cct = params.load_cc("p25", dev)
        cc_body = _p25_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                               sync_threshold, nac_out=True, tables=cct)
        ok_cols = (12, 50, 88)          # 3 TSBK CRC-ok bytes per TSDU
        if trunk_mode == "p25p1":
            vc_body = _p25_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                      sync_threshold, tables=cct.front)
        else:
            if not (p2_params and all(p2_params)):
                raise ValueError("trunk_mode='p25_mixed' needs "
                                 "p2_params=(wacn, sysid, nac): the "
                                 "sharded P2 body's scramble table is "
                                 "built once")
            w0, s0, n0 = p2_params
            vc_body = _p2_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                     w0, s0, n0, sync_threshold,
                                     tables=params.load_tdma("p25p2", dev))
            vc_rows = 2 * n_vc          # two TDMA slots per row
    elif trunk_mode == "dmr":
        cct = params.load_cc("dmr", dev)
        cc_body = _dmr_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                               sync_threshold, tables=cct)
        vc_body = _dmr_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                  sync_threshold, tables=cct.front)
        ok_cols = (12,)                 # the CSBK CRC-ok byte
    elif trunk_mode in ("nxdn48", "nxdn96"):
        # the 10-symbol FSW correlates only as a pre-filter; the LICH
        # gate decides
        thr = min(sync_threshold, 0.55)
        cct = params.load_cc(trunk_mode, dev)
        cc_body = _nxdn_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus, thr,
                                trunk_mode, tables=cct)
        vc_body = _nxdn_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                   thr, trunk_mode, tables=cct.front)
        ok_cols = (22,)                 # the CRC16-CAC ok byte
    else:                               # edacs
        cc_body = _edacs_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                                 sync_threshold, device=dev)
        vc_body = _analog_voice_body(CHANNEL_RATE)
        ok_cols = (8,)                  # the dual-polarity BCH ok byte
    R = n_cc + n_vc

    def step(wide: torch.Tensor, offs: torch.Tensor):
        if wide.shape[0] != Sl or tuple(offs.shape) != (Sl, R):
            raise ValueError(f"step built for {Sl} systems of {R} rows, "
                             f"got bands {list(wide.shape)} and offsets "
                             f"{list(offs.shape)}")
        rows = torch.stack([extract(wide[s], offs[s]) for s in range(Sl)])
        planes = torch.view_as_real(rows)             # [Sl, R, Bp, 2]
        cc_iq = planes[:, :n_cc].reshape(Sl * n_cc, Bp, 2)
        vc_iq = planes[:, n_cc:].reshape(Sl * n_vc, Bp, 2)
        blob, valid, meta = cc_body(cc_iq)
        pcm, _power = vc_body(vc_iq)
        fleet_ok = pdist.all_sum(mesh, _ok_count(blob, valid, ok_cols))
        return (blob.reshape(Sl, n_cc, max_tsdus, -1),
                valid.reshape(Sl, n_cc, max_tsdus),
                meta.reshape(Sl, n_cc, max_tsdus),
                pcm.reshape(Sl, vc_rows, -1), fleet_ok)

    return step, (lambda x: pdist.shard_rows(mesh, x, "system"),
                  lambda x: pdist.shard_rows(mesh, x, "system"))


# -- the multi-chip dry run ---------------------------------------------------
def dryrun_rank(mesh: pdist.Mesh) -> dict:
    """One rank of :func:`dryrun_multichip`: every sharded step once on
    the JAX dryrun's shapes and noise input, with its shape, finiteness
    and count checks; returns the rank's summary (the fleet metrics and
    the shapes)."""
    n = mesh.world
    C = max(n * 2, 8)                  # 2+ channels per rank
    B = 4800                           # 0.1 s per channel
    rng = np.random.default_rng(0)
    iq = rng.normal(size=(C, B, 2)).astype(np.float32)
    Cl = mesh.local_count(C)
    out = {}

    step, shard = make_sharded_frontend(mesh, "p25p1", C, B)
    dibits, _soft, _power, fleet = step(shard(iq))
    assert dibits.shape[0] == Cl
    assert np.isfinite(float(fleet))
    out["frontend_power"] = float(fleet)

    vstep, shard = make_sharded_voice_step(mesh, C, B)
    pcm, vfleet = vstep(shard(iq))
    assert tuple(pcm.shape) == (Cl, 2 * 9 * 160)
    assert torch.isfinite(pcm).all() and np.isfinite(float(vfleet))
    out["voice_power"] = float(vfleet)

    dstep, shard = make_sharded_dmr_voice_step(mesh, C, B)
    pcm_d, _dfleet = dstep(shard(iq))
    assert tuple(pcm_d.shape) == (Cl, 2 * 18 * 160)
    assert torch.isfinite(pcm_d).all()

    pstep, shard = make_sharded_p2_voice_step(mesh, C, B)
    pcm_p, _pfleet = pstep(shard(iq))
    assert tuple(pcm_p.shape) == (2 * Cl, 2 * 8 * 160)
    assert torch.isfinite(pcm_p).all()

    cstep, shard = make_sharded_p25_cc_step(mesh, C, B)
    blob, valid, ok_count = cstep(shard(iq))
    assert tuple(blob.shape[:2]) == (Cl, 4) and tuple(valid.shape) == (Cl, 4)
    assert int(ok_count) >= 0
    out["cc_ok"] = int(ok_count)

    # closed-loop trunking: S systems (1 CC + 2 voice rows each), the
    # offsets as data
    S = n
    FS = 4 * 48000.0
    Bw = 19200                         # 0.1 s of band per system
    wide = rng.normal(size=(S, Bw, 2)).astype(np.float32)
    offs = np.tile(np.array([[-48000, 0, 48000]], np.int32), (S, 1))
    tstep, (w_shard, o_shard) = make_sharded_trunk_step(
        mesh, S, FS, Bw, n_cc=1, n_vc=2, max_tsdus=2, max_ldus=1)
    tb, _tv, _tm, tpcm, tok = tstep(w_shard(wide), o_shard(offs))
    assert tuple(tb.shape) == (S // n, 1, 2, 114)
    assert tuple(tpcm.shape[:2]) == (S // n, 2)
    assert torch.isfinite(tpcm).all() and int(tok) >= 0

    # the NXDN Type-C and EDACS programs on the same closed loop
    nstep, (nw, no) = make_sharded_trunk_step(
        mesh, S, FS, Bw, n_cc=1, n_vc=1, max_tsdus=2, max_ldus=2,
        trunk_mode="nxdn48")
    nb, _nv, _nm, npcm, nok = nstep(nw(wide), no(offs[:, :2]))
    assert tuple(nb.shape) == (S // n, 1, 2, 23)
    assert tuple(npcm.shape[:2]) == (S // n, 1)
    assert torch.isfinite(npcm).all() and int(nok) >= 0

    estep, (ew, eo) = make_sharded_trunk_step(
        mesh, S, FS, Bw, n_cc=1, n_vc=1, max_tsdus=2, trunk_mode="edacs")
    eb, _ev, _em, epcm, eok = estep(ew(wide), eo(offs[:, :2]))
    assert tuple(eb.shape) == (S // n, 1, 2, 12)
    assert tuple(epcm.shape[:2]) == (S // n, 1)
    assert torch.isfinite(epcm).all() and int(eok) >= 0
    out.update(trunk_ok=int(tok), nxdn_ok=int(nok), edacs_ok=int(eok),
               pcm_shapes=[list(pcm.shape), list(pcm_d.shape),
                           list(pcm_p.shape), list(tpcm.shape)])
    return out


def dryrun_multichip(n_devices: int, device=None,
                     backend: str | None = None) -> list[dict]:
    """The multi-chip dry run: ``n_devices`` ranks, each running every
    sharded step once on tiny shapes (:func:`dryrun_rank`): the front end
    alone, the P25p1, DMR and P25p2 voice chains, P25p1 CC monitoring
    with its ``psum``, and the P25p1, NXDN48 and EDACS trunk steps.
    Ranks run on ``cuda:0..n-1`` under NCCL (raises with fewer cards),
    or on the CPU under gloo with ``device="cpu"``, or all on one named
    card (``backend="gloo"`` for more than one rank).  Returns each
    rank's summary."""
    return pdist.spawn(dryrun_rank, n_devices, device=device,
                       backend=backend)
