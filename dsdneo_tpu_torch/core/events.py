"""Call/event history: per-slot ring of decode events with severity +
category metadata, alert policy, reacquisition-aware end alerts,
epoch-keyed enrichment, revisioned snapshots, and log-file writing.

Reference parity: include/dsd-neo/core/events.h:32-166 and
src/core/util/dsd_events.c (per-slot Event_History ring with
severity/category, call-alert policy gated by a start/end/data event
mask, a VOICE_END alert held open across a possible reacquisition and
drained by the per-frame watchdog sync, alias/GPS/text enrichment keyed
by call epoch, revision-counted incremental telemetry snapshots, and
history reset) plus include/dsd-neo/runtime/call_alert.h (event-mask
normalization: a zero mask means "all events").

The same *contracts* in plain Python: this layer is small host
bookkeeping that the engine and UI threads share; no per-sample work
lives here.

The port's own copy of ``dsdneo_tpu/core/events.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from enum import IntEnum, IntFlag
from typing import Callable, Optional


class Severity(IntEnum):
    DEBUG = 0
    INFO = 1
    NOTICE = 2
    WARNING = 3
    ALERT = 4


class Category(IntEnum):
    """dsd_event_category (reference core/state.h:113-120)."""
    UNKNOWN = 0
    STATUS = 1
    VOICE = 2
    DATA = 3
    CONTROL = 4
    SYSTEM = 5


class CallKind(IntEnum):
    UNKNOWN = 0
    GROUP_VOICE = 1
    PRIVATE_VOICE = 2
    DATA = 3
    CONTROL = 4
    ENCRYPTED = 5


class AlertEvent(IntFlag):
    """dsd_call_alert_event_t (reference runtime/call_alert.h)."""
    VOICE_START = 1
    VOICE_END = 2
    DATA = 4
    ALL = 7


def normalize_alert_events(events: int) -> int:
    """Mask to known bits; preserve the historical zero-mask
    representation for "all events" (call_alert.h semantics)."""
    masked = int(events) & int(AlertEvent.ALL)
    return masked if masked else int(AlertEvent.ALL)


def alert_events_from_str(spec: str) -> int:
    """DSD_NEO_CALL_ALERT_EVENTS: comma list of start/end/data (the
    reference terminal menu's chooser set); empty or "all" = every
    event.  Unknown names are ignored (masked off)."""
    spec = (spec or "").strip().lower()
    if not spec or spec == "all":
        return int(AlertEvent.ALL)
    names = {"start": AlertEvent.VOICE_START, "end": AlertEvent.VOICE_END,
             "data": AlertEvent.DATA}
    mask = 0
    for part in spec.split(","):
        mask |= int(names.get(part.strip(), 0))
    return normalize_alert_events(mask) if mask else int(AlertEvent.ALL)


@dataclass
class AlertPolicy:
    """Which call milestones sound an operator alert (the -a beep and
    its per-event chooser in the reference terminal menu)."""
    enabled: bool = False
    events: int = int(AlertEvent.ALL)

    def wants(self, event: AlertEvent) -> bool:
        if not self.enabled:
            return False
        return bool(normalize_alert_events(self.events) & int(event))


@dataclass
class CallEvent:
    when: float
    protocol: str
    kind: CallKind
    slot: int = 0
    tg: int = 0
    src: int = 0
    freq_hz: float = 0.0
    text: str = ""
    severity: Severity = Severity.INFO
    category: Category = Category.VOICE
    ended: Optional[float] = None
    epoch: int = 0              # history-wide id; enrichment key
    alias: str = ""             # late alias enrichment (epoch-matched)
    gps: str = ""               # late GPS enrichment (epoch-matched)

    def duration(self) -> float:
        end = self.ended if self.ended is not None else time.time()
        return max(end - self.when, 0.0)


@dataclass
class _PendingEnd:
    """A VOICE_END alert armed at call end but held open across the
    reacquisition window (dsd_events.c watchdog_event_flush_pending_
    end_alert): a quickly reacquired transmission retracts it."""
    event: CallEvent
    due: float


class EventHistory:
    """Bounded per-slot ring of call events (2 TDMA slots + control).

    Mutations bump a per-slot ``revision`` so telemetry consumers can
    copy only slots that changed (dsd_event_state_copy_snapshot_
    incremental)."""

    def __init__(self, capacity: int = 256, slots: int = 2,
                 log_path: str | None = None,
                 alert_policy: AlertPolicy | None = None,
                 on_alert: Callable[[str, CallEvent], None] | None = None,
                 reacquire_window_s: float = 1.0):
        self.capacity = capacity
        self.rings: dict[int, list[CallEvent]] = {s: [] for s in range(slots)}
        self.active: dict[int, Optional[CallEvent]] = {s: None for s in range(slots)}
        self.revision: dict[int, int] = {s: 1 for s in range(slots)}
        self.log_path = log_path
        self._log_f = open(log_path, "a") if log_path else None
        self.alert_policy = alert_policy or AlertPolicy()
        self.on_alert = on_alert
        self.reacquire_window_s = reacquire_window_s
        self._pending_end: dict[int, _PendingEnd] = {}
        self._epoch = 0
        self.alerts_fired = 0

    # -- alert plumbing ------------------------------------------------------
    def _fire_alert(self, kind: str, ev: CallEvent) -> None:
        self.alerts_fired += 1
        if self.on_alert is not None:
            self.on_alert(kind, ev)

    def _mark_dirty(self, slot: int) -> None:
        r = self.rings.setdefault(slot, [])  # ensure slot exists
        del r  # only the side effect matters
        self.revision[slot] = (self.revision.get(slot, 0) + 1) or 1

    # -- call lifecycle ------------------------------------------------------
    def begin_call(self, ev: CallEvent) -> CallEvent:
        slot = ev.slot
        # reacquisition: the same talkgroup keying back up while its
        # VOICE_END alert is still held open merges into the previous
        # row and retracts the pending alert (dsd_events.c:381-392)
        pend = self._pending_end.get(slot)
        if (pend is not None and pend.event.tg == ev.tg
                and pend.event.kind == ev.kind):
            del self._pending_end[slot]
            row = pend.event
            row.ended = None
            row.src = ev.src or row.src
            self.active[slot] = row
            self._mark_dirty(slot)
            return row
        cur = self.active.get(slot)
        if cur is not None and (cur.tg != ev.tg or cur.kind != ev.kind):
            self.end_call(slot)
            cur = None
        if cur is None:
            self._epoch += 1
            ev.epoch = self._epoch
            self.active[slot] = ev
            self._append(slot, ev)
            self._write_log(ev, "START")
            if (ev.kind in (CallKind.GROUP_VOICE, CallKind.PRIVATE_VOICE,
                            CallKind.ENCRYPTED)
                    and self.alert_policy.wants(AlertEvent.VOICE_START)):
                self._fire_alert("voice_start", ev)
            return ev
        cur.src = ev.src or cur.src
        return cur

    def end_call(self, slot: int, when: float | None = None,
                 final: bool = True) -> None:
        """Close the active call.  ``final=False`` commits the row
        without arming the end alert (the reference's nonfinalizing
        call notice — no end alert, no identity reset)."""
        cur = self.active.get(slot)
        if cur is None:
            return
        now = when if when is not None else time.time()
        cur.ended = now
        self._write_log(cur, "END")
        self.active[slot] = None
        self._mark_dirty(slot)
        if (final
                and cur.kind in (CallKind.GROUP_VOICE,
                                 CallKind.PRIVATE_VOICE, CallKind.ENCRYPTED)
                and self.alert_policy.wants(AlertEvent.VOICE_END)):
            # hold the alert open against a possible reacquisition;
            # sync() drains it once the window elapses
            self._pending_end[slot] = _PendingEnd(
                event=cur, due=now + self.reacquire_window_s)

    def sync(self, slot: int | None = None,
             now: float | None = None) -> None:
        """Per-frame watchdog tick (dsd_event_sync_slot): retire held
        VOICE_END alerts whose reacquisition window has elapsed."""
        now = now if now is not None else time.time()
        slots = [slot] if slot is not None else list(self._pending_end)
        for s in slots:
            pend = self._pending_end.get(s)
            if pend is not None and now >= pend.due:
                del self._pending_end[s]
                self._fire_alert("voice_end", pend.event)

    def flush_pending_alerts(self) -> None:
        """Retire every held VOICE_END alert immediately — shutdown
        path (dsd_event_flush_pending_alerts): an end armed in the last
        moments before exit must still be heard."""
        for s, pend in list(self._pending_end.items()):
            del self._pending_end[s]
            self._fire_alert("voice_end", pend.event)

    # -- notices -------------------------------------------------------------
    def note(self, slot: int, text: str, severity: Severity = Severity.INFO,
             protocol: str = "",
             category: Category = Category.STATUS) -> None:
        ev = CallEvent(when=time.time(), protocol=protocol,
                       kind=CallKind.CONTROL, slot=slot, text=text,
                       severity=severity, category=category,
                       ended=time.time())
        self._epoch += 1
        ev.epoch = self._epoch
        self._append(slot, ev)
        self._write_log(ev, "NOTE")

    def data_notice(self, slot: int, text: str,
                    category: Category = Category.DATA,
                    gps: str = "", protocol: str = "") -> bool:
        """Commit a data/control notice.  Only DATA and CONTROL are
        accepted; invalid categories are rejected without changing
        history (dsd_event_emit_data_notice_classified contract).
        Sounds the DATA alert when the policy asks for it."""
        if category not in (Category.DATA, Category.CONTROL):
            return False
        ev = CallEvent(when=time.time(), protocol=protocol,
                       kind=CallKind.DATA, slot=slot, text=text,
                       category=category, gps=gps, ended=time.time())
        self._epoch += 1
        ev.epoch = self._epoch
        self._append(slot, ev)
        self._write_log(ev, "DATA")
        if self.alert_policy.wants(AlertEvent.DATA):
            self._fire_alert("data", ev)
        return True

    def system_notice(self, slot: int, text: str) -> None:
        """Informational system notice not attributed to radio traffic
        (dsd_event_emit_system_notice)."""
        self.note(slot, text, severity=Severity.NOTICE,
                  category=Category.SYSTEM)

    # -- enrichment ----------------------------------------------------------
    def _find_epoch(self, slot: int, epoch: int) -> Optional[CallEvent]:
        for ev in reversed(self.rings.get(slot, [])):
            if ev.epoch == epoch:
                return ev
        return None

    def enrich_alias(self, slot: int, epoch: int, alias: str) -> bool:
        """Attach a late-arriving talker alias to the call row it keyed
        (dsd_event_enrich_alias): alias frames decode after the voice
        grant, so they carry the call epoch instead of assuming the
        active row is still theirs."""
        ev = self._find_epoch(slot, epoch)
        if ev is None:
            return False
        ev.alias = alias
        self._mark_dirty(slot)
        return True

    def enrich_gps(self, slot: int, epoch: int, gps: str) -> bool:
        ev = self._find_epoch(slot, epoch)
        if ev is None:
            return False
        ev.gps = gps
        self._mark_dirty(slot)
        return True

    def enrich_text(self, slot: int, epoch: int, text: str) -> bool:
        ev = self._find_epoch(slot, epoch)
        if ev is None:
            return False
        ev.text = (ev.text + " " + text).strip() if ev.text else text
        self._mark_dirty(slot)
        return True

    # -- snapshots -----------------------------------------------------------
    def snapshot(self, slot: int = 0, n: int = 20) -> list[CallEvent]:
        """Copy of the most recent events (the UI-facing view)."""
        return [replace(e) for e in list(self.rings.get(slot, []))[-n:]]

    def snapshot_incremental(self, known: dict[int, int] | None = None,
                             force: bool = False, n: int = 20):
        """Copy only slots whose revision moved past ``known``
        (dsd_event_state_copy_snapshot_incremental): returns
        (slot → event-list copies for changed slots, current
        slot → revision map)."""
        known = known or {}
        out: dict[int, list[CallEvent]] = {}
        revs = dict(self.revision)
        for s, rev in revs.items():
            if force or known.get(s) != rev:
                out[s] = self.snapshot(s, n=n)
        return out, revs

    def reset(self) -> None:
        """Clear every row on every slot and the commit bookkeeping
        with it (dsd_event_history_reset): pending alerts die with the
        rows they reference."""
        for s in self.rings:
            self.rings[s] = []
            self.active[s] = None
            self._mark_dirty(s)
        self._pending_end.clear()

    # -- internals -----------------------------------------------------------
    def _append(self, slot: int, ev: CallEvent) -> None:
        ring = self.rings.setdefault(slot, [])
        if slot not in self.revision:
            self.revision[slot] = 1
        ring.append(ev)
        if len(ring) > self.capacity:
            del ring[: len(ring) - self.capacity]
        self._mark_dirty(slot)

    def _write_log(self, ev: CallEvent, tag: str) -> None:
        if self._log_f is None:
            return
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ev.when))
        extra = ""
        if ev.alias:
            extra += f" ALIAS={ev.alias}"
        if ev.gps:
            extra += f" GPS={ev.gps}"
        self._log_f.write(
            f"{ts} [{tag}] {ev.protocol} slot={ev.slot} kind={ev.kind.name} "
            f"cat={ev.category.name} TG={ev.tg} SRC={ev.src}"
            f"{extra} {ev.text}\n")
        self._log_f.flush()

    def close(self) -> None:
        for s in list(self.active):
            self.end_call(s)
        self.flush_pending_alerts()
        if self._log_f:
            self._log_f.close()
            self._log_f = None
