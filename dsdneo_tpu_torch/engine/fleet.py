"""Fleet orchestration: one serving loop over many channels of mixed
protocols, composed of the batched pipelines.

Counterpart of ``dsdneo_tpu/engine/fleet.py``.  A ``FleetMonitor`` owns
groups of channels, each bound to one batched pipeline (voice or
control); every pushed ``[C_total, B]`` block is sliced into the groups'
sub-batches and each group's device work runs.  Voice groups return PCM
per channel, control groups collect trunking events; ``channel_dicts``
gives the channel grid's rows.  Groups share the card in turn within a
block: each pipeline is a whole-card batched program already.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np

from dsdneo_tpu_torch.device import require_cuda

# mode → (module, pipeline class)
_VOICE_FACTORIES = {
    "p25p1": ("dsdneo_tpu_torch.engine.voicebatch",
              "BatchedP25VoicePipeline"),
    "p25p2": ("dsdneo_tpu_torch.engine.p2batch", "BatchedP2VoicePipeline"),
    "dmr": ("dsdneo_tpu_torch.engine.dmrbatch", "BatchedDmrVoicePipeline"),
    "nxdn48": ("dsdneo_tpu_torch.engine.nxdnbatch",
               "BatchedNxdnVoicePipeline"),
    "nxdn96": ("dsdneo_tpu_torch.engine.nxdnbatch",
               "BatchedNxdnVoicePipeline"),
    "ysf": ("dsdneo_tpu_torch.engine.ysfbatch", "BatchedYsfVoicePipeline"),
    "dpmr": ("dsdneo_tpu_torch.engine.dpmrbatch", "BatchedDpmrVoicePipeline"),
    "x2tdma": ("dsdneo_tpu_torch.engine.x2batch", "BatchedX2VoicePipeline"),
    "m17": ("dsdneo_tpu_torch.engine.m17batch", "BatchedM17VoicePipeline"),
    "dstar": ("dsdneo_tpu_torch.engine.dstarbatch", "BatchedDstarPipeline"),
}
_CC_FACTORIES = {
    "p25p1": ("dsdneo_tpu_torch.engine.ccbatch",
              "BatchedP25ControlPipeline"),
    "dmr": ("dsdneo_tpu_torch.engine.ccbatch", "BatchedDmrControlPipeline"),
    "nxdn48": ("dsdneo_tpu_torch.engine.ccbatch",
               "BatchedNxdnControlPipeline"),
    "nxdn96": ("dsdneo_tpu_torch.engine.ccbatch",
               "BatchedNxdnControlPipeline"),
    "edacs": ("dsdneo_tpu_torch.engine.ccbatch",
              "BatchedEdacsControlPipeline"),
}


def _make(table, mode, C, fs, kw, device):
    if mode not in table:
        raise ValueError(f"no batched pipeline for mode {mode!r}")
    mod_name, cls_name = table[mode]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    if mode == "nxdn96" and "mode" not in kw:
        # the NXDN pipelines, voice and control, default to the
        # 2400-baud nxdn48 front end: a 9600-baud group must say so
        kw = dict(kw, mode="nxdn96")
    return cls(C, fs=fs, device=device, **kw)


@dataclass
class FleetGroup:
    """One contiguous channel range bound to a pipeline."""
    mode: str
    kind: str                 # "voice" | "cc"
    start: int                # first channel index in the fleet block
    count: int
    pipeline: object
    freqs: list = field(default_factory=list)
    pcm: np.ndarray | None = None


class FleetMonitor:
    """Mixed-protocol fleet over one ``[C_total, B(, 2)]`` block per step,
    on ``device`` (the card when none is given; raises when there is
    none).

    ``assign(mode, count, kind="voice", freqs=None, **kw)`` appends a
    group; ``decode_block(iq)`` runs every group over its channel slice.
    Voice PCM lands in ``group.pcm``; control events collect in each
    control pipeline's per-channel contexts.
    """

    def __init__(self, fs: float = 48000.0, workers: int | None = None,
                 *, device=None):
        self.fs = fs
        self.device = require_cuda() if device is None else device
        self.groups: list[FleetGroup] = []
        self.blocks = 0
        # DSD_NEO_MT: a 2-thread pool overlaps the groups' host work;
        # single-threaded by default
        if workers is None:
            from dsdneo_tpu_torch.runtime import config as rtcfg
            workers = 2 if rtcfg.get().mt else 0
        self._pool = None
        if workers:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=workers)

    @property
    def total_channels(self) -> int:
        return sum(g.count for g in self.groups)

    def assign(self, mode: str, count: int, kind: str = "voice",
               freqs=None, **kw) -> FleetGroup:
        table = _VOICE_FACTORIES if kind == "voice" else _CC_FACTORIES
        pipe = _make(table, mode, count, self.fs, kw, self.device)
        g = FleetGroup(mode=mode, kind=kind, start=self.total_channels,
                       count=count, pipeline=pipe,
                       freqs=list(freqs or [0.0] * count))
        self.groups.append(g)
        return g

    def decode_block(self, iq) -> None:
        """Run one fleet block: ``iq`` is ``[C_total, B(, 2)]``.

        Three phases: every group's front end is queued first; then each
        group's candidates come to the host, are picked and its second
        stage queued (the voice decode) or its events parsed, while later
        groups' front ends run; the voice PCM is fetched last."""
        assert iq.shape[0] == self.total_channels, (
            f"block carries {iq.shape[0]} channels, fleet has "
            f"{self.total_channels}")
        staged = []
        for g in self.groups:                       # phase 1: dispatch
            sub = iq[g.start:g.start + g.count]
            p = g.pipeline
            two_stage = hasattr(p, "frontend_dispatch") and (
                hasattr(p, "decode_from_frontend") if g.kind == "voice"
                else hasattr(p, "events_from_frontend"))
            fe = p.frontend_dispatch(sub) if two_stage else None
            staged.append((g, sub, fe))

        def _mid(item):                             # phase 2
            g, sub, fe = item
            p = g.pipeline
            if fe is None:                          # one-call pipelines
                if g.kind == "voice":
                    g.pcm = p.decode_block(sub)
                else:
                    p.decode_block_events(sub)
                return g, None
            fin = p.frontend_finish(fe)
            if g.kind == "voice":
                return g, p.decode_from_frontend(fin)
            p.events_from_frontend(fin)
            return g, None

        if self._pool is not None:
            handles = list(self._pool.map(_mid, staged))
        else:
            handles = [_mid(s) for s in staged]
        for g, h in handles:                        # phase 3: PCM fetch
            if h is not None:
                g.pcm = g.pipeline.fetch_pcm(h)
        self.blocks += 1

    def events(self, channel: int):
        """All events of a fleet channel (control groups only)."""
        for g in self.groups:
            if g.start <= channel < g.start + g.count:
                if hasattr(g.pipeline, "events"):
                    return g.pipeline.events(channel - g.start)
                return []
        raise IndexError(channel)

    def channel_dicts(self) -> list[dict]:
        """Channel-grid rows, one per fleet channel."""
        from dsdneo_tpu_torch.ui.panes import channels_from_contexts
        out = []
        for g in self.groups:
            if g.kind == "cc":
                rows = channels_from_contexts(g.pipeline.ctxs,
                                              freqs=g.freqs)
                for i, r in enumerate(rows):
                    r["id"] = g.start + i
                out.extend(rows)
            else:
                for i in range(g.count):
                    if hasattr(g.pipeline, "channel_state"):
                        # event pipelines (D-STAR, M17) report activity
                        # from decoded frames, not PCM
                        state = g.pipeline.channel_state(i)
                    else:
                        active = False
                        if g.pcm is not None and g.pcm.shape[1] > 0:
                            if g.pcm.shape[0] == 2 * g.count:
                                # 2-slot TDMA pipelines emit per-slot
                                # rows at 2·ch + slot
                                active = (np.abs(
                                    g.pcm[2 * i:2 * i + 2]).max() > 1e-4)
                            else:
                                active = np.abs(g.pcm[i]).max() > 1e-4
                        state = "voice" if active else "idle"
                    out.append({"id": g.start + i,
                                "freq_hz": g.freqs[i],
                                "state": state,
                                "tg": 0})
        return out
