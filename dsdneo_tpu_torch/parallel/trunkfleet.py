"""Closed-loop trunking of S systems, one wideband stream each, sharded
over the ranks of a mesh: grants rewrite the voice rows' offsets between
steps with nothing rebuilt.

Counterpart of ``dsdneo_tpu/parallel/trunkfleet.py``.  It joins
``engine.fleettrunk.TrunkedFleet`` (the one-stream closed loop) and
``parallel.mesh.make_sharded_trunk_step`` (every system's row
extraction, CC decode and voice decode as one step per rank).  Each rank
keeps the host control plane of its own systems: the catalog parse
through the port's ``Batched*ControlPipeline`` host halves, grant
resolution (the iden table or a ``ChannelMap``), row allocation,
hangtime and grace releases, and the ``p25_mixed`` slot calls.  System
indices (``sys {s}`` in the log, the rows' ids) are global; ``calls``,
``calls2`` and ``offs`` hold the rank's systems, in order.
:meth:`ShardedTrunkedFleet.gather` gives every rank the whole fleet's
view.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dsdneo_tpu_torch.device import to_host
from dsdneo_tpu_torch.engine.fleettrunk import (CHANNEL_RATE, FleetStats,
                                                VoiceCall, _Staged)
from dsdneo_tpu_torch.parallel import dist as pdist
from dsdneo_tpu_torch.parallel.mesh import make_sharded_trunk_step
from dsdneo_tpu_torch.runtime import handoff


@dataclass
class FleetView:
    """The whole fleet as every rank sees it after a gather: the log lines
    per system, in system order (each system's lines in time order),
    the rank logs' other lines (WARN) in rank order, the summed stats,
    the rows (``row_dicts``) and offsets ``[S, 1 + n_vc]`` of every
    system, and each system's calls."""
    log: list
    other_log: list
    stats: FleetStats
    rows: list
    offs: np.ndarray
    calls: list
    calls2: list


class ShardedTrunkedFleet:
    """S trunked systems over the ranks of ``mesh``, one CC and
    ``n_voice_rows`` concurrent voice rows each; each rank decodes its
    ``S / world`` systems on its device (the mesh's card).  ``mode``:
    ``"p25p1"`` (TSBK / LDU), ``"dmr"`` (Tier III CSBK / AMBE),
    ``"nxdn48"`` / ``"nxdn96"`` (Type-C CAC / AMBE), ``"edacs"`` (BCH CC
    / analog NBFM) or ``"p25_mixed"`` (P1 TSBK CC granting TDMA channels
    into the Phase 2 body: PCM rows are ``2·n_vc`` per-slot rows; needs
    ``p2_params=(wacn, sysid, nac)``).

    ``cc_offsets_hz[s]``: system s's control-channel offset from its band
    centre (integer Hz); ``centers_hz[s]``: its absolute band centre (a
    scalar broadcasts).  ``step(wide)`` takes one block of every system
    (``[S, B]`` complex, ``[S, B, 2]`` float32 or uint8 CU8 planes; or
    the rank's ``[S / world, ...]`` rows), uploads the rank's rows and
    returns its systems' ``[S / world, R_v, T]`` float32 PCM.

    Grants seen in block N retarget rows for block N+1.  The voice bodies
    start every step from a fresh state, so a retargeted row needs no
    carry reset.
    """

    def __init__(self, mesh: pdist.Mesh, n_systems: int, fs: float, B: int,
                 cc_offsets_hz, n_voice_rows: int, centers_hz=0.0,
                 mode: str = "p25p1", hangtime_s: float = 1.0,
                 grant_grace_s: float = 1.5,
                 sync_threshold: float = 0.62, tg_policy=None,
                 chan_map=None, max_tsdus: int = 4, max_ldus: int = 2,
                 p2_params=None, edacs_ea: bool = False,
                 esk_mask: int = 0):
        from dsdneo_tpu_torch.engine.ccbatch import (
            BatchedDmrControlPipeline, BatchedEdacsControlPipeline,
            BatchedNxdnControlPipeline, BatchedP25ControlPipeline)
        if mode not in ("p25p1", "p25_mixed", "dmr", "nxdn48", "nxdn96",
                        "edacs"):
            raise ValueError("ShardedTrunkedFleet drives the p25p1, dmr, "
                             "nxdn48/96, edacs, or p25_mixed CC+voice "
                             f"bodies (got mode={mode!r})")
        self.mesh = mesh
        self.device = mesh.device
        self.S = n_systems
        self.Sl = mesh.local_count(n_systems, "system")
        self.s0 = mesh.rank * self.Sl             # first global system
        self.fs = fs
        self.B = B
        self.mode = mode
        self.n_vc = n_voice_rows
        self.hangtime_s = hangtime_s
        self.grant_grace_s = grant_grace_s
        self.tg_policy = tg_policy or (lambda tg: True)
        self.chan_map = chan_map
        mine = mesh.rows(n_systems, "system")
        centers = np.broadcast_to(np.asarray(centers_hz, np.float64),
                                  (n_systems,))
        self.centers = centers[mine].copy()
        self.offs = np.zeros((self.Sl, 1 + n_voice_rows), np.int32)
        self.offs[:, 0] = np.asarray(cc_offsets_hz, np.int32)[mine]
        self.offs[:, 1:] = self.offs[:, :1]       # park voice on the CC
        self.step_fn, _shards = \
            make_sharded_trunk_step(mesh, n_systems, fs, B, n_cc=1,
                                    n_vc=n_voice_rows, max_tsdus=max_tsdus,
                                    max_ldus=max_ldus,
                                    sync_threshold=sync_threshold,
                                    trunk_mode=mode, p2_params=p2_params)
        # host halves only (catalog parse, parse cache, iden tables);
        # ctx s belongs to the rank's system s
        dev = self.device
        if mode in ("p25p1", "p25_mixed"):
            self._cc_host = BatchedP25ControlPipeline(
                self.Sl, fs=CHANNEL_RATE, device=dev)
        elif mode == "dmr":
            self._cc_host = BatchedDmrControlPipeline(
                self.Sl, fs=CHANNEL_RATE, device=dev)
        elif mode in ("nxdn48", "nxdn96"):
            self._cc_host = BatchedNxdnControlPipeline(
                self.Sl, fs=CHANNEL_RATE, mode=mode, device=dev)
        else:
            self._cc_host = BatchedEdacsControlPipeline(
                self.Sl, fs=CHANNEL_RATE, ea_mode=edacs_ea,
                esk_mask=esk_mask, device=dev)
        if chan_map is not None:
            for ctx in self._cc_host.ctxs:
                ctx.state.chan_map = chan_map
        self.calls: list[dict[int, VoiceCall]] = [
            dict() for _ in range(self.Sl)]
        # p25_mixed: TDMA calls keyed (row, slot); the two slots of one
        # granted frequency share one extraction row
        self.calls2: list[dict[tuple, VoiceCall]] = [
            dict() for _ in range(self.Sl)]
        self._free: list[list[int]] = [list(range(n_voice_rows))
                                       for _ in range(self.Sl)]
        self._ev_cursor = [0] * self.Sl
        self.clock = 0.0
        self.blocks = 0
        self.stats = FleetStats()
        self.log: list[str] = []
        self.sys_log: list[list[str]] = [[] for _ in range(self.Sl)]
        self._next_block = None        # the prefetched block

    def _say(self, s: int, text: str) -> None:
        """A log line of the rank's system ``s`` (global index in the
        text)."""
        line = f"[{self.clock:7.2f}s] sys {self.s0 + s} {text}"
        self.log.append(line)
        self.sys_log[s].append(line)

    # -- host control plane ---------------------------------------------------
    def _parse_blobs(self, blob: np.ndarray, valid: np.ndarray,
                     meta: np.ndarray) -> int:
        """Walk the ``[Sl, 1, K, W]`` CC blobs through each system's
        catalog parser.  P25 (and p25_mixed): W=114 TSDU blobs, meta = NID
        message.  DMR: W=14 CSBK blobs, meta = slot-type colour code.
        NXDN: W=23 CAC blobs, meta = LICH.  EDACS: W=12 message pairs,
        meta = polarity."""
        from dsdneo_tpu_torch.engine.ccbatch import TSDU_BLOB, TSDU_BLOCKS
        n_parsed = 0
        for s in range(self.Sl):
            ctx = self._cc_host.ctxs[s]
            for k in range(blob.shape[2]):
                if not valid[s, 0, k]:
                    continue
                pos = self.blocks * 100 + k
                if self.mode == "dmr":
                    if blob[s, 0, k, 12]:
                        self._cc_host._parse_csbk(
                            s, pos, int(meta[s, 0, k]) & 0xF,
                            blob[s, 0, k, :12])
                        n_parsed += 1
                    continue
                if self.mode in ("nxdn48", "nxdn96"):
                    n_parsed += self._parse_cac(s, pos, blob[s, 0, k])
                    continue
                if self.mode == "edacs":
                    n_parsed += self._parse_edacs(s, pos, blob[s, 0, k])
                    continue
                nac = (int(meta[s, 0, k]) >> 4) & 0xFFF
                if nac not in (0, 0xFFF):
                    ctx.state.nac = nac
                    ctx.state.p2_cc = nac
                blk = blob[s, 0, k].reshape(TSDU_BLOCKS, TSDU_BLOB)
                for b in range(TSDU_BLOCKS):
                    if blk[b, 12]:
                        data = blk[b, :12]
                    else:
                        data = self._cc_host._crc_fallback(blk[b, 13:])
                        if data is None:
                            break
                    n_parsed += 1
                    if self._cc_host._parse_tsbk(s, pos, data):
                        break
        return n_parsed

    def _parse_cac(self, s: int, pos: int, row: np.ndarray) -> int:
        """One NXDN CAC blob row through the host catalog (the monitor's
        ``events_from_frontend`` parse)."""
        ctx = self._cc_host.ctxs[s]
        if not row[22]:
            self._cc_host.crc_errors += 1
            ctx.emit(" CAC CRC ERR", "nxdn", pos)
            return 0
        dec = np.unpackbits(row[:22])[:171]
        ran = 0
        for b in dec[2:8]:
            ran = (ran << 1) | int(b)
        ctx.state.nxdn_ran = ran
        detail = self._cc_host.decs[s]._message(dec[8:155], ctx)
        ctx.emit(f"Sync: NXDN CC  RCCH CAC RAN {ran:02d}{detail}",
                 "nxdn", pos, ran=ran)
        return 1

    def _parse_edacs(self, s: int, pos: int, row: np.ndarray) -> int:
        """One EDACS message pair through the standard or EA catalog
        (the monitor's ``events_from_frontend`` parse)."""
        from dsdneo_tpu_torch.engine.ccbatch import _sync_def
        from dsdneo_tpu_torch.symbols.framesync import SyncHit
        ctx = self._cc_host.ctxs[s]
        if not row[8]:
            self._cc_host.bch_errors += 1
            ctx.emit("Sync: +EDACS  BCH FAIL", "edacs", pos)
            return 0
        v1 = int(row[0:4].copy().view("<u4")[0])
        v2 = int(row[4:8].copy().view("<u4")[0])
        esk = int(getattr(ctx.state, "edacs_esk", 0) or 0)
        if esk:
            v1 ^= (esk & 0xFF) << 20
            v2 ^= (esk & 0xFF) << 20
        dec = self._cc_host.decs[s]
        hit = SyncHit(pos=pos, score=1.0,
                      sync=_sync_def(self._cc_host.SYNC_NAMES[0]))
        if getattr(ctx.state, "edacs_ea", False):
            line = dec._extended(v1, v2, ctx, hit)
        else:
            line = dec._standard(v1, v2, ctx, hit)
        pol = "-" if row[9] else "+"
        ctx.emit(f"Sync: {pol}EDACS {line}", "edacs", pos,
                 mt=v1 >> 23, word=v1)
        return 1

    def _resolve_freq(self, s: int, fields: dict) -> float:
        ch = int(fields.get("channel", 0) or 0)
        if ch not in (0, 0xFFFF):
            it = getattr(self._cc_host.ctxs[s].state, "iden_table", None)
            if it is not None:
                f = it.channel_to_freq(ch)
                if f:
                    return float(f)
            if self.chan_map is not None:
                f = self.chan_map.freq(ch)
                if f:
                    return float(f)
        # DMR Tier III grants carry an LPCN instead of a P25 iden
        # channel: resolved through the channel map
        lpcn = int(fields.get("lpcn", 0) or 0)
        if lpcn not in (0, 0xFFF) and self.chan_map is not None:
            f = self.chan_map.freq(lpcn)
            if f:
                return float(f)
        return 0.0

    def _on_grant(self, s: int, fields: dict) -> None:
        tg = int(fields.get("tg", 0) or 0)
        freq = self._resolve_freq(s, fields)
        if freq <= 0:
            self.stats.unresolved += 1
            return
        off = int(round(freq - self.centers[s]))
        if abs(off) > self.fs / 2 - CHANNEL_RATE / 2:
            self.stats.unresolved += 1
            return
        if self.mode == "p25_mixed":
            self._on_grant_p2(s, fields, tg, freq, off)
            return
        for call in self.calls[s].values():
            if int(round(call.freq_hz - self.centers[s])) == off:
                call.last_voice = self.clock
                self.stats.grant_refreshes += 1
                return
        if not self.tg_policy(tg):
            self.stats.policy_drops += 1
            return
        if not self._free[s]:
            self.stats.busy_drops += 1
            return
        row = self._free[s].pop(0)
        self.offs[s, 1 + row] = off
        self.calls[s][row] = VoiceCall(
            row=row, tg=tg, src=int(fields.get("src", 0) or 0),
            freq_hz=freq, system=self.s0 + s, granted_at=self.clock,
            last_voice=self.clock)
        self.stats.grants += 1
        self._say(s, f"GRANT TG {tg} -> row {row} @ {freq / 1e6:.4f} MHz")

    def _on_grant_p2(self, s: int, fields: dict, tg: int, freq: float,
                     off: int) -> None:
        """A p25_mixed TDMA grant → a (row, slot) call; the other slot of
        a granted frequency shares its row."""
        ch = int(fields.get("channel", 0) or 0)
        it = getattr(self._cc_host.ctxs[s].state, "iden_table", None)
        if it is not None:
            ent = it.entries.get((ch >> 12) & 0xF)
            if ent and ent[3] < 2:
                # an FDMA grant on the mixed CC: every voice row is
                # Phase 2, so nothing here decodes it
                self.stats.unresolved += 1
                return
        slot = it.channel_to_slot(ch) if it is not None else 0
        g = self.s0 + s
        for (row, sl), call in self.calls2[s].items():
            if int(round(call.freq_hz - self.centers[s])) != off:
                continue
            if sl == slot:
                call.last_voice = self.clock
                self.stats.grant_refreshes += 1
                return
            if (row, slot) in self.calls2[s]:
                continue        # our slot's call rides another entry
            self.calls2[s][(row, slot)] = VoiceCall(
                row=row, tg=tg, src=int(fields.get("src", 0) or 0),
                freq_hz=freq, system=g, granted_at=self.clock,
                last_voice=self.clock, slot=slot)
            self.stats.grants += 1
            self._say(s, f"GRANT TG {tg} -> p2 row {row} slot {slot} @ "
                         f"{freq / 1e6:.4f} MHz")
            return
        if not self.tg_policy(tg):
            self.stats.policy_drops += 1
            return
        if not self._free[s]:
            self.stats.busy_drops += 1
            return
        row = self._free[s].pop(0)
        self.offs[s, 1 + row] = off
        self.calls2[s][(row, slot)] = VoiceCall(
            row=row, tg=tg, src=int(fields.get("src", 0) or 0),
            freq_hz=freq, system=g, granted_at=self.clock,
            last_voice=self.clock, slot=slot)
        self.stats.grants += 1
        self._say(s, f"GRANT TG {tg} -> p2 row {row} slot {slot} @ "
                     f"{freq / 1e6:.4f} MHz")

    def _walk_cc_events(self) -> None:
        for s in range(self.Sl):
            evs = self._cc_host.ctxs[s].events
            for ev in evs[self._ev_cursor[s]:]:
                if ev.fields.get("grant"):
                    self._on_grant(s, ev.fields)
            self._ev_cursor[s] = len(evs)

    def _tick_releases(self) -> None:
        for s in range(self.Sl):
            for row, call in list(self.calls[s].items()):
                idle = self.clock - call.last_voice
                age = self.clock - call.granted_at
                if idle > self.hangtime_s and age > self.grant_grace_s:
                    self._say(s, f"RELEASE TG {call.tg} row {row} "
                                 f"({call.pcm_samples} samples)")
                    del self.calls[s][row]
                    self._free[s].append(row)
                    self.offs[s, 1 + row] = self.offs[s, 0]
                    self.stats.releases += 1
            for key, call in list(self.calls2[s].items()):
                idle = self.clock - call.last_voice
                age = self.clock - call.granted_at
                if idle > self.hangtime_s and age > self.grant_grace_s:
                    row, slot = key
                    self._say(s, f"RELEASE TG {call.tg} p2 row {row} slot "
                                 f"{slot} ({call.pcm_samples} samples)")
                    del self.calls2[s][key]
                    self.stats.releases += 1
                    # park the row only once both slots are done
                    if not any(r == row for r, _ in self.calls2[s]):
                        self._free[s].append(row)
                        self.offs[s, 1 + row] = self.offs[s, 0]

    # -- the step ------------------------------------------------------------
    def _local(self, wide):
        """The rank's rows of a host block (all S systems' rows, or
        already the rank's), as float32 planes or uint8 CU8."""
        wide = np.asarray(wide)
        if wide.shape[0] == self.S and self.S != self.Sl:
            wide = wide[self.mesh.rows(self.S, "system")]
        elif wide.shape[0] != self.Sl:
            raise ValueError(f"a block of {wide.shape[0]} systems, the "
                             f"fleet has {self.S} ({self.Sl} on this rank)")
        if np.iscomplexobj(wide):
            return np.stack([wide.real, wide.imag],
                            axis=-1).astype(np.float32)
        if wide.dtype != np.uint8:
            return np.ascontiguousarray(wide, dtype=np.float32)
        return np.ascontiguousarray(wide)

    def prefetch(self, wide):
        """Start copying the rank's rows of the next host block to the
        device and return a handle that :meth:`step` takes in place of a
        block.  On the card the rows are staged in pinned memory and
        copied with ``non_blocking=True`` on a side stream; the step that
        takes them waits on the copy's event.  A tensor passes through."""
        if isinstance(wide, (_Staged, torch.Tensor)):
            return wide
        host = torch.from_numpy(self._local(wide))
        if self.device.type != "cuda":
            return _Staged(host.to(self.device))
        host = host.pin_memory()
        return _Staged(*handoff.copy_in(host, self.device), host)

    def _take(self, wide) -> torch.Tensor:
        if wide is None:
            wide = self._next_block
            self._next_block = None
            if wide is None:
                raise ValueError("step(None) without a prefetched block")
        elif self._next_block is not None:
            # a fresh block supersedes a queued prefetch
            self.log.append(f"[{self.clock:7.2f}s] WARN: prefetched "
                            "block dropped (step called with a fresh "
                            "block while one was queued)")
            self._next_block = None
        if isinstance(wide, _Staged):
            if wide.event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(wide.event)
                wide.tensor.record_stream(cur)
            return wide.tensor
        if isinstance(wide, torch.Tensor):
            if wide.shape[0] == self.S and self.S != self.Sl:
                wide = wide[self.mesh.rows(self.S, "system")]
            return wide.to(self.device)
        return torch.from_numpy(self._local(wide)).to(self.device)

    def step(self, wide, prefetch=None) -> np.ndarray:
        """One block of every system → the rank's ``[S / world, R_v, T]``
        PCM.  ``wide=None`` takes the block queued by an earlier
        ``prefetch=``; a host block given as ``prefetch=`` starts its
        copy once this block's device work is queued."""
        x = self._take(wide)
        block_s = self.B / self.fs
        out = self.step_fn(x, torch.from_numpy(self.offs).to(self.device))
        if prefetch is not None:
            self._next_block = self.prefetch(prefetch)
        # the four outputs come to the host together
        blob, valid, msg, pcm = to_host(out[:4])
        act_mask = np.zeros(pcm.shape[:2] + (1,), pcm.dtype)
        if pcm.shape[2]:
            energy = np.abs(pcm).mean(axis=2)              # [Sl, R_v]
            for s in range(self.Sl):
                for row, call in self.calls[s].items():
                    act_mask[s, row] = 1.0
                    if energy[s, row] > 1e-4:
                        call.last_voice = self.clock + block_s
                        call.pcm_samples += int(pcm.shape[2])
                # p25_mixed: PCM row 2·row + slot
                for (row, slot), call in self.calls2[s].items():
                    r = 2 * row + slot
                    act_mask[s, r] = 1.0
                    if energy[s, r] > 1e-4:
                        call.last_voice = self.clock + block_s
                        call.pcm_samples += int(pcm.shape[2])
        self.clock += block_s
        self.blocks += 1
        self._parse_blobs(blob, valid, msg)
        self._walk_cc_events()
        self._tick_releases()
        return pcm * act_mask

    # -- introspection --------------------------------------------------------
    def row_dicts(self) -> list[dict]:
        """The rank's systems' rows: the CC row, then the voice rows, ids
        (global system, row)."""
        out = []
        for s in range(self.Sl):
            g = self.s0 + s
            out.append({"id": (g, 0), "freq_hz": float(self.offs[s, 0]),
                        "state": "cc", "tg": 0})
            for v in range(self.n_vc):
                call = self.calls[s].get(v)
                slots = {sl: c for (r, sl), c in self.calls2[s].items()
                         if r == v}
                if slots:
                    state = "p2 " + " ".join(
                        f"s{sl} TG {c.tg}"
                        for sl, c in sorted(slots.items()))
                    tg = next(iter(slots.values())).tg
                elif call:
                    state, tg = f"voice TG {call.tg}", call.tg
                else:
                    state, tg = "idle", 0
                out.append({"id": (g, 1 + v),
                            "freq_hz": float(self.offs[s, 1 + v]),
                            "state": state, "tg": tg})
        return out

    def gather(self) -> FleetView:
        """The whole fleet's view on every rank (a collective: every rank
        calls it)."""
        mine = {"sys_log": self.sys_log,
                "other": [ln for ln in self.log if " sys " not in ln],
                "stats": dataclasses.asdict(self.stats),
                "rows": self.row_dicts(), "offs": self.offs,
                "calls": self.calls, "calls2": self.calls2}
        parts = pdist.gather_objects(self.mesh, mine)
        stats = FleetStats()
        for p in parts:
            for k, v in p["stats"].items():
                setattr(stats, k, getattr(stats, k) + v)
        return FleetView(
            log=[ln for p in parts for lines in p["sys_log"] for ln in lines],
            other_log=[ln for p in parts for ln in p["other"]],
            stats=stats,
            rows=[r for p in parts for r in p["rows"]],
            offs=np.concatenate([p["offs"] for p in parts]),
            calls=[c for p in parts for c in p["calls"]],
            calls2=[c for p in parts for c in p["calls2"]])
