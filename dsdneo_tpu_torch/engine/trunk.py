"""Trunking state machines, channel maps and tuner control (host).

The port's own copy of ``dsdneo_tpu/engine/trunk.py`` (pure Python),
unchanged in its logic: the unified trunking state machine ``TrunkSM``
(IDLE / ON_CC / TUNED / HUNTING with grant, release and tick events,
hangtime, CC hunt and its on-disk candidate cache, the decision log),
the single-tuner rotation ``TrunkScanner`` with the trunk-scan target
CSV, the P25 iden table, the explicit channel map, and
``TrunkFollower``, which turns decode events into the state machine's
inputs.  In the live one-tuner path a tune is a retune of the tuner
(``engine.live.LiveEngine.tune``); in the trunked fleet it is a row's
NCO rewrite between device steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional


class TrunkPhase(Enum):
    IDLE = 0        # no system acquired
    ON_CC = 1       # camped on the control channel
    TUNED = 2       # following a voice grant
    HUNTING = 3     # lost CC; rotating candidate list


@dataclass
class GrantEvent:
    freq_hz: float
    tg: int
    src: int
    channel: int = 0
    svc: int = 0
    phase2: bool = False
    slot: int = 0


@dataclass
class IdenTable:
    """P25 channel-number → frequency math (reference
    src/protocol/p25/p25_frequency.c iden_up records)."""
    entries: dict = field(default_factory=dict)  # iden -> (base_hz, spacing_hz, offset_hz, tdma_slots)
    version: int = 0        # bumped on change: parse caches key on it

    def add(self, iden: int, base_hz: float, spacing_hz: float,
            offset_hz: float = 0.0, tdma_slots: int = 1) -> None:
        ent = (base_hz, spacing_hz, offset_hz, max(tdma_slots, 1))
        if self.entries.get(iden) != ent:
            self.version += 1
        self.entries[iden] = ent

    def channel_to_freq(self, channel16: int) -> Optional[float]:
        iden = (channel16 >> 12) & 0xF
        chan = channel16 & 0xFFF
        ent = self.entries.get(iden)
        if ent is None:
            return None
        base, spacing, _off, slots = ent
        return base + (chan // slots) * spacing

    def channel_to_slot(self, channel16: int) -> int:
        iden = (channel16 >> 12) & 0xF
        ent = self.entries.get(iden)
        if ent is None:
            return 0
        return (channel16 & 0xFFF) % ent[3]


class TrunkSM:
    """Unified trunking follower (P25 P1/P2 + DMR T3 share the model)."""

    def __init__(self, tune: Callable[[float, str], bool],
                 policy: Optional[Callable[[int], bool]] = None,
                 hangtime_s: float = 1.0, vc_grace_s: float = 1.5,
                 cc_timeout_s: float = 5.0,
                 now_fn: Callable[[], float] = time.monotonic,
                 cc_cache_path: str = "",
                 grant_timeout_s: float = 0.0,
                 min_follow_dwell_s: float = 0.0,
                 force_release_extra_s: float = 0.0,
                 force_release_margin_s: float = 0.0,
                 err_hold_pct: float = 0.0, err_hold_s: float = 0.0,
                 mac_hold_s: float = 0.0, ring_hold_s: float = 0.0,
                 voice_hold_s: float = 0.0,
                 cc_cache_enable: bool = True):
        self.tune = tune
        self.policy = policy or (lambda tg: True)
        self.hangtime_s = hangtime_s
        self.vc_grace_s = vc_grace_s
        self.cc_timeout_s = cc_timeout_s
        self.now = now_fn
        # reference trunk-SM timing knobs (docs/cli.md:629-646
        # DSD_NEO_P25_GRANT_TIMEOUT / MIN_FOLLOW_DWELL /
        # FORCE_RELEASE_EXTRA+MARGIN / P25P1_ERR_HOLD_PCT+S and the
        # MAC/RING/VOICE audio-hold windows); 0 disables a knob
        self.grant_timeout_s = grant_timeout_s
        self.min_follow_dwell_s = min_follow_dwell_s
        self.force_release_extra_s = force_release_extra_s
        self.force_release_margin_s = force_release_margin_s
        self.err_hold_pct = err_hold_pct
        self.err_hold_s = err_hold_s
        self.mac_hold_s = mac_hold_s
        self.ring_hold_s = ring_hold_s
        self.voice_hold_s = voice_hold_s

        self.phase = TrunkPhase.IDLE
        self.cc_freq: float = 0.0
        self.vc_freq: float = 0.0
        self.cc_candidates: list[float] = []
        self.hunt_index = 0
        # CC hunt rotation: learned/cached candidates, plus the full
        # imported channel map (cli -C); -^ prefers candidates first
        self.hunt_all: list[float] = []
        self.prefer_candidates = True
        self.hunt_dwell_s = 1.0       # settle + 1 TSBK before rotating
        self._last_hunt_at = 0.0
        self.current_tg = 0
        self.last_cc_seen = 0.0
        self.last_vc_activity = 0.0
        self.tuned_at = 0.0
        self.first_voice_at = 0.0     # 0 = no voice yet on this grant
        self.last_mac_activity = 0.0
        self.last_audio_out = 0.0
        self.err_hold_until = 0.0     # high-error hangtime extension
        self.events: list[str] = []
        # on-disk CC candidate cache (reference p25_cc_candidates.c +
        # DSD_NEO_P25_CC_CACHE, docs/cli.md:642): warm-start the hunt
        # list across runs; DSD_NEO_CC_CACHE=0 disables the load
        self.cc_cache_path = cc_cache_path
        # SM decision log file (reference --p25-sm-log,
        # src/core/file/p25_sm_log.c): every phase transition appended
        self.log_path = ""
        if cc_cache_path and cc_cache_enable:
            self._load_cc_cache()

    @staticmethod
    def kwargs_from_config(cfg, mode: str = "p25p1") -> dict:
        """Map the RuntimeConfig's reference-name trunking knobs
        (docs/cli.md:629-646) onto TrunkSM constructor kwargs; the
        grant timeout picks the per-protocol knob by mode."""
        import os
        grant_to = cfg.p25_grant_timeout_s
        if mode.startswith("dmr") and cfg.dmr_grant_timeout_s > 0:
            grant_to = cfg.dmr_grant_timeout_s
        cache = cfg.cc_cache_path
        if not cache and cfg.cache_dir:
            # DSD_NEO_CACHE_DIR locates historical CC cache files
            cache = os.path.join(cfg.cache_dir, "cc_candidates.json")
        return dict(
            grant_timeout_s=grant_to,
            min_follow_dwell_s=cfg.p25_min_follow_dwell_s,
            force_release_extra_s=cfg.p25_force_release_extra_s,
            force_release_margin_s=cfg.p25_force_release_margin_s,
            err_hold_pct=cfg.p25p1_err_hold_pct,
            err_hold_s=cfg.p25p1_err_hold_s,
            mac_hold_s=cfg.p25_mac_hold_s,
            ring_hold_s=cfg.p25_ring_hold_s,
            voice_hold_s=cfg.p25_voice_hold_s,
            cc_cache_path=cache,
            cc_cache_enable=cfg.cc_cache_enable)

    # -- CC candidate disk cache -------------------------------------------
    def _load_cc_cache(self) -> None:
        import json
        import os
        if not os.path.exists(self.cc_cache_path):
            return
        try:
            with open(self.cc_cache_path) as f:
                data = json.load(f)
            cands = [float(x) for x in data.get("cc_candidates", [])]
            self.cc_candidates = cands[:16]
        except (OSError, ValueError):
            pass

    def _save_cc_cache(self) -> None:
        import json
        if not self.cc_cache_path:
            return
        try:
            with open(self.cc_cache_path, "w") as f:
                json.dump({"cc_candidates": self.cc_candidates}, f)
        except OSError:
            pass

    # -- inputs -----------------------------------------------------------
    def on_cc_activity(self, freq_hz: float) -> None:
        """Control-channel frame decoded at freq (NID/TSBK/CSBK)."""
        self.last_cc_seen = self.now()
        if self.phase in (TrunkPhase.IDLE, TrunkPhase.HUNTING):
            self.phase = TrunkPhase.ON_CC
            self.cc_freq = freq_hz
            self._log(f"ON_CC {freq_hz/1e6:.4f} MHz")
        if freq_hz not in self.cc_candidates:
            self.cc_candidates.insert(0, freq_hz)
            del self.cc_candidates[16:]
            self._save_cc_cache()

    def on_grant(self, ev: GrantEvent) -> bool:
        if self.phase == TrunkPhase.TUNED:
            return False
        if not self.policy(ev.tg):
            self._log(f"grant blocked TG {ev.tg}")
            return False
        if ev.freq_hz <= 0:
            return False
        if self.tune(ev.freq_hz, "voice"):
            self.phase = TrunkPhase.TUNED
            self.vc_freq = ev.freq_hz
            self.current_tg = ev.tg
            self.tuned_at = self.now()
            self.last_vc_activity = self.tuned_at
            self.first_voice_at = 0.0
            self.err_hold_until = 0.0
            self._log(f"TUNED TG {ev.tg} @ {ev.freq_hz/1e6:.4f} MHz")
            return True
        return False

    def on_voice_activity(self) -> None:
        self.last_vc_activity = self.now()
        if not self.first_voice_at:
            self.first_voice_at = self.last_vc_activity

    def on_mac_activity(self) -> None:
        """MAC/LC signalling on the tuned carrier keeps the slot
        audio-eligible (reference DSD_NEO_P25_MAC_HOLD window)."""
        self.last_mac_activity = self.now()

    def on_audio_out(self) -> None:
        """PCM actually emitted — feeds the ring-hold gate window
        (reference DSD_NEO_P25_RING_HOLD)."""
        self.last_audio_out = self.now()

    def on_voice_errs(self, pct: float) -> None:
        """Per-frame IMBE error percentage: above the configured
        threshold the hangtime deadline is extended (reference
        DSD_NEO_P25P1_ERR_HOLD_PCT/_S, docs/cli.md:378-380) so a noisy
        but live call is not released mid-transmission."""
        if self.err_hold_pct > 0 and self.err_hold_s > 0 \
                and pct >= self.err_hold_pct:
            self.err_hold_until = self.now() + self.err_hold_s

    def audio_eligible(self) -> bool:
        """Audio gate consulted by the live loop while TUNED: recent
        voice (VOICE_HOLD), recent MAC signalling (MAC_HOLD), or recent
        audio output (RING_HOLD) keep the slot open.  All windows
        default to 0 = always eligible (the reference's gates are
        advisory unless configured)."""
        if self.voice_hold_s <= 0:
            return True
        now = self.now()
        if now - self.last_vc_activity <= self.voice_hold_s:
            return True
        if (self.mac_hold_s > 0 and self.last_mac_activity
                and now - self.last_mac_activity <= self.mac_hold_s):
            return True
        if (self.ring_hold_s > 0 and self.last_audio_out
                and now - self.last_audio_out <= self.ring_hold_s):
            return True
        return False

    def on_release(self, forced: bool = False,
                   retune: bool = True) -> None:
        """``retune=False`` releases the SM state without issuing the
        CC tune — for preemption, where the very next action is a tune
        to the new voice channel (the intermediate CC hop would double
        tuner settle time right as the high-priority call starts)."""
        if self.phase != TrunkPhase.TUNED:
            return
        if retune:
            self._return_to_cc("release" + (" (forced)" if forced else ""))
        else:
            self.phase = TrunkPhase.ON_CC
            self.vc_freq = 0.0
            self.current_tg = 0
            self._log("release (no CC hop: preempt)")

    # -- periodic tick (the reference's watchdog + frame-loop tick,
    #    p25_sm_watchdog.c / p25_trunk_sm.c:4792) -------------------------
    def tick(self) -> None:
        now = self.now()
        if self.phase == TrunkPhase.TUNED:
            # grant timeout: tuned but voice never arrived
            # (DSD_NEO_P25_GRANT_TIMEOUT / DSD_NEO_DMR_GRANT_TIMEOUT)
            if (self.grant_timeout_s > 0 and not self.first_voice_at
                    and now - self.tuned_at > self.grant_timeout_s):
                self._return_to_cc("grant timeout")
                return
            # force-release safety net beyond hangtime
            # (DSD_NEO_P25_FORCE_RELEASE_EXTRA + _MARGIN): overrides
            # every suppression below
            if self.force_release_extra_s > 0:
                budget = (self.hangtime_s + self.force_release_extra_s
                          + self.force_release_margin_s)
                if now - self.last_vc_activity > budget:
                    self._return_to_cc("force release")
                    return
            # high-error hangtime extension (P25P1_ERR_HOLD)
            hang_deadline = max(self.last_vc_activity + self.hangtime_s,
                                self.err_hold_until)
            # minimum follow dwell after first voice
            # (DSD_NEO_P25_MIN_FOLLOW_DWELL)
            if (self.first_voice_at and self.min_follow_dwell_s > 0
                    and now - self.first_voice_at < self.min_follow_dwell_s):
                return
            if (now > hang_deadline
                    and now - self.tuned_at > self.vc_grace_s):
                self._return_to_cc("hangtime expired")
        elif self.phase == TrunkPhase.ON_CC:
            if now - self.last_cc_seen > self.cc_timeout_s:
                self.phase = TrunkPhase.HUNTING
                self.hunt_index = 0
                self._log("CC lost → HUNTING")
        elif self.phase == TrunkPhase.HUNTING:
            # dwell: rotating faster than the tuner settles + one
            # TSBK/CSBK decodes (~100+ ms) would thrash past the CC
            if now - self._last_hunt_at < self.hunt_dwell_s:
                return
            extra = [f for f in self.hunt_all
                     if f not in self.cc_candidates]
            pool = (self.cc_candidates + extra if self.prefer_candidates
                    else extra + self.cc_candidates)
            if pool:
                f = pool[self.hunt_index % len(pool)]
                self.hunt_index += 1
                self._last_hunt_at = now
                self.tune(f, "cc")
                self._log(f"hunt {f/1e6:.4f} MHz")

    # -- internals --------------------------------------------------------
    def _return_to_cc(self, why: str) -> None:
        self.phase = TrunkPhase.ON_CC
        self.vc_freq = 0.0
        self.current_tg = 0
        if self.cc_freq:
            self.tune(self.cc_freq, "cc")
        self._log(f"→ CC ({why})")

    def _log(self, msg: str) -> None:
        self.events.append(msg)
        if self.log_path:
            try:
                with open(self.log_path, "a") as f:
                    f.write(f"{self.now():.3f} {self.phase.name} {msg}\n")
            except OSError:
                self.log_path = ""


@dataclass
class ScanTarget:
    freq_hz: float
    mode: str
    label: str = ""


class TrunkScanner:
    """Single-tuner rotation over multiple systems (reference
    src/engine/trunk_scan.c:1795 — dwell + activity hold, ≤32 targets)."""

    MAX_TARGETS = 32

    def __init__(self, tune: Callable[[float, str], bool],
                 dwell_s: float = 1.0, hold_s: float = 5.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.targets: list[ScanTarget] = []
        self.tune = tune
        self.dwell_s = dwell_s
        self.hold_s = hold_s
        self.now = now_fn
        self.index = -1
        self.switched_at = 0.0
        self.last_activity = 0.0

    def add_target(self, t: ScanTarget) -> bool:
        if len(self.targets) >= self.MAX_TARGETS:
            return False
        self.targets.append(t)
        return True

    def on_activity(self) -> None:
        self.last_activity = self.now()

    def tick(self) -> Optional[ScanTarget]:
        if not self.targets:
            return None
        now = self.now()
        active_hold = now - self.last_activity < self.hold_s
        if self.index >= 0 and (active_hold or now - self.switched_at < self.dwell_s):
            return self.targets[self.index]
        self.index = (self.index + 1) % len(self.targets)
        t = self.targets[self.index]
        self.tune(t.freq_hz, t.mode)
        self.switched_at = now
        return t


class ChannelMap:
    """Explicit channel-number → frequency map imported from CSV
    (reference csv importers, docs/csv-formats.md: DMR T3 / Cap+ /
    Con+ / NXDN / EDACS '<number>,<frequency Hz>' files)."""

    def __init__(self):
        self.entries: dict[int, float] = {}

    def import_csv(self, path: str) -> int:
        """Header line is skipped; rows are 'channel,frequency_hz[,...]'.
        Returns the number of imported rows."""
        n = 0
        with open(path, errors="replace") as f:
            for i, row in enumerate(f):
                parts = [p.strip() for p in row.split(",")]
                if len(parts) < 2:
                    continue
                try:
                    chan = int(parts[0])
                    freq = float(parts[1])
                except ValueError:
                    continue          # header / comment rows
                if freq <= 0:
                    continue
                self.entries[chan] = freq
                n += 1
        return n

    def freq(self, chan: int) -> Optional[float]:
        return self.entries.get(chan)

    def heuristic_fill(self) -> int:
        """DMR Tier III heuristic LCN gap fill (reference
        dmr_csbk.c dmr_heuristic_collect_anchor_stats /
        _estimate_step / _validate_model / _fill_gaps, opt-in via
        DSD_NEO_DMR_T3_HEUR): from ≥2 learned LCN→frequency anchors,
        estimate the per-LCN channel step, validate that every anchor
        fits the linear model exactly, then fill the gaps between the
        lowest and highest known LCN.  Returns the number of entries
        added (0 when the anchors don't support a confident model)."""
        anchors = sorted((c, f) for c, f in self.entries.items() if c > 0)
        if len(anchors) < 2:
            return 0
        # step estimate: gcd of Δfreq/ΔLCN over adjacent anchors
        import math
        step = 0
        for (c0, f0), (c1, f1) in zip(anchors, anchors[1:]):
            d_lcn = c1 - c0
            d_hz = int(round(f1 - f0))
            if d_lcn <= 0 or d_hz <= 0 or d_hz % d_lcn:
                return 0               # non-monotone / fractional step
            step = math.gcd(step, d_hz // d_lcn)
        if step < 1000 or step > 1_000_000:
            return 0                   # implausible channel raster
        base_lcn, base_f = anchors[0]
        for c, f in anchors:           # validate: exact linear fit
            if abs((base_f + (c - base_lcn) * step) - f) > 1.0:
                return 0
        filled = 0
        for c in range(base_lcn + 1, anchors[-1][0]):
            if c not in self.entries:
                self.entries[c] = base_f + (c - base_lcn) * step
                filled += 1
        return filled


@dataclass
class TrunkScanTarget:
    """One row of a trunk-scan rotation list (reference
    examples/trunk_scan_targets.csv + src/engine/trunk_scan.c)."""
    id: str
    type: str
    frequency_hz: float
    chan_csv: str = ""
    dwell_ms: int = 3000
    activity_hold_ms: int = 0
    modulation: str = "auto"


def import_trunk_scan_targets(path: str, limit: int = 32
                              ) -> list[TrunkScanTarget]:
    """Parse the reference's trunk_scan_targets.csv format (≤32 targets,
    engine/trunk_scan.h:23-30)."""
    import csv as _csv
    out: list[TrunkScanTarget] = []
    with open(path, newline="", errors="replace") as f:
        for row in _csv.DictReader(f):
            try:
                freq = float(row.get("frequency_hz", "") or 0)
            except ValueError:
                continue
            if freq <= 0 or not row.get("id"):
                continue
            def _int(key, default):
                try:
                    return int(row.get(key, "") or default)
                except ValueError:
                    return default
            out.append(TrunkScanTarget(
                id=row["id"].strip(), type=(row.get("type") or "").strip(),
                frequency_hz=freq,
                chan_csv=(row.get("chan_csv") or "").strip(),
                dwell_ms=_int("dwell_ms", 3000),
                activity_hold_ms=_int("activity_hold_ms", 0),
                modulation=(row.get("modulation") or "auto").strip() or "auto"))
            if len(out) >= limit:
                break
    return out


def load_scan_targets(scanner: "TrunkScanner", path: str) -> int:
    """Import trunk_scan_targets.csv rows into a TrunkScanner."""
    n = 0
    for t in import_trunk_scan_targets(path, limit=scanner.MAX_TARGETS):
        if scanner.add_target(ScanTarget(freq_hz=t.frequency_hz,
                                         mode=t.modulation, label=t.id)):
            n += 1
    return n


class TrunkFollower:
    """Bridges decode events into the TrunkSM — the reference's engine
    wiring (src/engine/engine.c: protocol handlers → p25_sm_event /
    dmr_sm_event → trunk_tuning hook → retune).

    Grant-tagged events resolve channel→frequency through the P25 iden
    table learned off the control channel, then the imported channel
    map (which also covers DMR LPCN/LCN numbering); release-tagged
    events return to the control channel; any decoded frame refreshes
    the CC timer (ON_CC) or the voice hangtime (TUNED)."""

    def __init__(self, sm: TrunkSM, ctx, chan_map: Optional[ChannelMap] = None,
                 current_freq: Callable[[], float] = lambda: 0.0):
        self.sm = sm
        self.ctx = ctx
        self.chan_map = chan_map
        self.current_freq = current_freq
        # tune policy (reference -E/-p/-e flags): which grant kinds
        # the follower acts on
        self.tune_group = True
        self.tune_private = True
        self.tune_data = False
        # encryption lockout (reference --enc-lockout, simplified: a
        # grant whose service options carry the encryption bit locks
        # its talkgroup for the session; --enc-follow leaves this off)
        self.enc_lockout = False
        self.enc_locked: set = set()
        self.enc_skips = 0
        self.grants = 0
        self.releases = 0
        # priority preemption (reference docs/cli.md:382-384
        # DSD_NEO_TG_PREEMPT_MIN_DWELL_MS / _COOLDOWN_MS over the group
        # list's priority/preempt policy columns): a preempt-enabled
        # grant whose priority exceeds the active call's may displace
        # it, after a minimum dwell and with a cooldown between
        # displacement attempts
        self.preempt_min_dwell_s = 0.75
        self.preempt_cooldown_s = 1.0
        self._last_preempt = 0.0
        self.preemptions = 0
        # grant-to-voice timeout ledger (DSD_NEO_P25_GRANT_VOICE_TO):
        # pending tune requests the SM could not take (already TUNED)
        # expire instead of queueing forever
        self.grant_voice_to_s = 0.0
        self._pending_grant: Optional[GrantEvent] = None
        self._pending_at = 0.0

    def resolve_freq(self, fields: dict) -> float:
        ch = int(fields.get("channel", 0) or 0)
        if ch:
            it = getattr(self.ctx.state, "iden_table", None)
            if it is not None:
                f = it.channel_to_freq(ch)
                if f:
                    return float(f)
            if self.chan_map is not None:
                f = self.chan_map.freq(ch)
                if f:
                    return float(f)
        lpcn = int(fields.get("lpcn", 0) or 0)
        if lpcn and self.chan_map is not None:
            f = self.chan_map.freq(lpcn)
            if f:
                return float(f)
            from dsdneo_tpu_torch.runtime import config as rtcfg
            if rtcfg.get().dmr_t3_heur and self.chan_map.heuristic_fill():
                # DSD_NEO_DMR_T3_HEUR: the learned-anchor linear model
                # may now cover the granted LCN
                f = self.chan_map.freq(lpcn)
                if f:
                    return float(f)
        return 0.0

    def clear_enc_lockouts(self) -> None:
        """Menu action: purge the session encryption-lockout ledger."""
        self.enc_locked.clear()

    def on_event(self, ev) -> None:
        f = ev.fields
        if f.get("grant"):
            # tune policy gates (reference -E/-p/-e)
            if f.get("data"):
                if not self.tune_data:
                    return
            elif f.get("private"):
                if not self.tune_private:
                    return
            elif not self.tune_group:
                return
            tg = int(f.get("tg", 0) or 0)
            if self.enc_lockout and tg:
                if tg in self.enc_locked:
                    self.enc_skips += 1
                    return
                if int(f.get("svc", 0) or 0) & 0x40:
                    self.enc_locked.add(tg)
                    self.enc_skips += 1
                    return
            if self.sm.phase in (TrunkPhase.IDLE, TrunkPhase.HUNTING):
                # the grant itself proves we are camped on a control
                # channel: anchor cc_freq first so release/hangtime has
                # somewhere to return to (reference dmr_cspdu
                # init_cc_anchor / nxdn_anchor_control_channel)
                cur = self.current_freq()
                if cur > 0:
                    self.sm.on_cc_activity(cur)
            freq = self.resolve_freq(f)
            if freq > 0:
                ev2 = GrantEvent(
                    freq_hz=freq, tg=tg,
                    src=int(f.get("src", 0) or 0),
                    channel=int(f.get("channel", f.get("lpcn", 0)) or 0))
                if self.sm.phase == TrunkPhase.TUNED:
                    if self._try_preempt(ev2):
                        return
                    # park the grant in the grant-to-voice ledger: it
                    # is retried on release until GRANT_VOICE_TO expires
                    if self.grant_voice_to_s > 0:
                        self._pending_grant = ev2
                        self._pending_at = self.sm.now()
                    return
                ok = self.sm.on_grant(ev2)
                self.grants += ok
            return
        if f.get("release"):
            self.releases += 1
            self.sm.on_release()
            self._retry_pending()
            return
        if self.sm.phase == TrunkPhase.TUNED:
            self.sm.on_voice_activity()
            if f.get("mac") or f.get("lc"):
                self.sm.on_mac_activity()
            pct = f.get("errs_pct")
            if pct is not None:
                self.sm.on_voice_errs(float(pct))
        else:
            cur = self.current_freq()
            if cur > 0:
                self.sm.on_cc_activity(cur)

    def _try_preempt(self, ev: GrantEvent) -> bool:
        """Displace the active call for a higher-priority preempt-
        enabled grant (group-list policy columns)."""
        pol = getattr(self.ctx.state, "tg_policy", None)
        if pol is None or not hasattr(pol, "preempts"):
            return False
        if not pol.preempts(ev.tg):
            return False
        if pol.priority(ev.tg) <= pol.priority(self.sm.current_tg):
            return False
        now = self.sm.now()
        if now - self.sm.tuned_at < self.preempt_min_dwell_s:
            return False
        if now - self._last_preempt < self.preempt_cooldown_s:
            return False
        self._last_preempt = now
        # VC→VC directly: the CC hop would cost a second tuner settle
        self.sm.on_release(forced=True, retune=False)
        if self.sm.on_grant(ev):
            self.preemptions += 1
            self.grants += 1
            return True
        if self.sm.cc_freq:
            # the skipped CC hop must happen after all when the
            # preempting grant is denied downstream
            self.sm.tune(self.sm.cc_freq, "cc")
        return False

    def _retry_pending(self) -> None:
        ev = self._pending_grant
        if ev is None:
            return
        if self.sm.now() - self._pending_at > self.grant_voice_to_s:
            self._pending_grant = None      # grant-to-voice expired
            return
        self._pending_grant = None
        self.grants += self.sm.on_grant(ev)

    def tick(self) -> None:
        if (self._pending_grant is not None and self.grant_voice_to_s > 0
                and self.sm.now() - self._pending_at > self.grant_voice_to_s):
            self._pending_grant = None
        self.sm.tick()
