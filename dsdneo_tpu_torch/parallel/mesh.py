"""The device TSDU pick of the P25 Phase 1 control channel.

Counterpart of ``_p25_cc_body`` and ``_topk_shoulder_mask`` of
``dsdneo_tpu/parallel/mesh.py``, as one device's body: the trunked
fleet's ``cc_device_pick`` runs it in place of the host pick.  The
sharded steps of that module wait for the multi-GPU slice.

Per ``[Cl, B, 2]`` block of control rows: the front end (kernel K1 on
the card), the sync matched filter, the ``max_tsdus`` best positions per
row (a stable sort, so equal scores keep the lower position first, as
``jax.lax.top_k`` does), the BCH(63,16) NID of each as a codebook
argmax, the valid mask (score, DUID 7, upright sync, the TSDU inside the
block, and optionally the shoulder suppression) and the TSBK trellis
decode of every candidate (kernel K4 on the card).
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine.batched import frontend_step
from dsdneo_tpu_torch.engine.ccbatch import p25_tsdu_decode_device
from dsdneo_tpu_torch.engine.voicebatch import (_status_strip_map,
                                                correlate_syncs_device)


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


def _p25_cc_body(Cl: int, B: int, fs: float = 48000.0,
                 max_tsdus: int = 4, sync_threshold: float = 0.62,
                 nac_out: bool = False, dedup: bool = False, *,
                 tables: params.CcTables):
    """The body for ``[Cl, B, 2]`` float32 I/Q planes on ``tables``'
    device → ``([Cl, max_tsdus, 114]`` uint8 TSDU blobs, ``[Cl,
    max_tsdus]`` valid mask``[, [Cl, max_tsdus]`` NID messages``])``.
    Blob layout: 3 × (12 payload bytes, the CRC-ok byte, 25 bytes of raw
    dibits).  Built for one block length ``B``."""
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
        if iq.shape[:2] != (Cl, B):
            raise ValueError(f"body built for [{Cl}, {B}], got "
                             f"{list(iq.shape[:2])}")
        dibits, soft, _power = frontend_step(iq, t.taps, sps, n_sym,
                                             t.four_level)
        sc = correlate_syncs_device(soft, t.sync_levels)
        best_def = torch.argmax(sc, dim=1)
        bs = torch.amax(sc, dim=1)
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :K], idx[:, :K]                # [Cl, K]
        gpos = torch.clamp(idx[:, :, None] + nid_strip, 0,
                           dibits.shape[1] - 1)
        nd = dibits[rows[:, None, None], gpos].to(torch.int64)
        b64 = torch.stack([(nd >> 1) & 1, nd & 1], dim=-1
                          ).reshape(Cl, K, 64)
        s = 1.0 - 2.0 * b64[..., :63].to(torch.float32)
        msg = torch.argmax(s.reshape(-1, 63) @ pm_t, dim=-1
                           ).reshape(Cl, K).to(torch.int32)
        duid = msg & 0xF
        inv = torch.gather(best_def, 1, idx) & 1
        valid = ((vals >= sync_threshold) & (duid == 7) & (inv == 0)
                 & (idx + need < n_sym))
        if dedup:
            valid = valid & ~_topk_shoulder_mask(idx)
        ch = torch.where(valid, rows[:, None], Cl).reshape(-1)
        blob = p25_tsdu_decode_device(dibits, ch, idx.reshape(-1), tables)
        blob = blob.reshape(Cl, K, -1)
        if nac_out:
            return blob, valid, msg
        return blob, valid

    return body
