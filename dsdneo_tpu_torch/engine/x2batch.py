"""Batched X2-TDMA two-slot voice: I/Q → PCM on the card.

Counterpart of ``dsdneo_tpu/engine/x2batch.py``.  X2-TDMA's voice
superframe has DMR's geometry (6 bursts at the 288-dibit same-slot
period, 3 AMBE+2 frames per burst at the same payload offsets), so the
device program is ``engine.dmrbatch.dmr_voice_decode_gather``.  What
differs from DMR: 6000 symbols/s and the 12.5 kHz channel filter (the
``x2tdma`` tables), the two X2 voice syncs, and the acceptance gate.
X2 carries P25-style embedded signalling, not QR EMBs, in the
mid-superframe centres, so the dispatch runs no EMB decode and its
confidence column is zero: a candidate is accepted on its sync score,
and the device AMBE mask gates the frames.
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline


class BatchedX2VoicePipeline(BatchedDmrVoicePipeline):
    """Drives the batched X2-TDMA voice chain over ``[C, B, 2]`` float32
    I/Q blocks on ``device`` (the card when none is given; raises when
    there is no card).  Both sync patterns are upright, so no candidate
    is taken as inverted."""

    SYNC_NAMES = ("+X2-TDMA BS voice", "+X2-TDMA MS voice")
    SYNC_TOPK = 128
    TRACE_PREFIX = "x2"

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, pcm_fmt: str = "f16", *,
                 device=None, tables: params.TdmaTables | None = None):
        if device is None:
            device = require_cuda()
        if tables is None:
            tables = params.load_tdma("x2tdma", device)
        super().__init__(C, fs, sync_threshold, pcm_fmt, device=device,
                         tables=tables)

    def emb_errors(self, dibits, idx, dq):
        """No EMB gate: a zero confidence column."""
        return torch.zeros(idx.shape, dtype=torch.uint8, device=self.device)
