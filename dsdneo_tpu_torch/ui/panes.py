"""Terminal panes: call history, channel grid, trunking status.

Pure string renderers (no curses dependency — unit-testable headless)
for the reference's ncurses frontend panes:

- call history (src/ui/terminal/dsd_ncurses_printer.c call-history
  table): TIME | KIND | TG | SRC | SLOT | DUR | FLAGS per CallEvent;
- channel grid (the trunked-fleet view): one cell per monitored
  channel showing id / frequency / state / last talkgroup, fed from
  app_control metric snapshots or the batched CC pipelines' contexts;
- trunking status (site pane): WACN/SYS/NAC, iden table rows, patch
  and affiliation summaries from the decode context state.

The port's own copy of ``dsdneo_tpu/ui/panes.py`` (host Python),
unchanged in its logic; ``engine.fleet.FleetMonitor.channel_dicts``
renders its control groups with ``channels_from_contexts``.
"""

from __future__ import annotations

import time


def _fmt_dur(s: float) -> str:
    return f"{int(s // 60):d}:{s % 60:04.1f}" if s >= 60 else f"{s:4.1f}s"


def call_history_rows(history, width: int, height: int = 12,
                      slot: int | None = None,
                      now: float | None = None) -> list[str]:
    """Render the most recent CallEvents of an EventHistory as a
    fixed-column table (newest last)."""
    from dsdneo_tpu_torch.core.events import CallKind
    now = now if now is not None else time.time()
    rows = [" TIME     KIND      TG        SRC        S  DUR     INFO"[:width]]
    evs = []
    slots = [slot] if slot is not None else sorted(history.rings)
    for s in slots:
        evs.extend(history.snapshot(s, n=height))
    evs.sort(key=lambda e: e.when)
    kind_names = {CallKind.GROUP_VOICE: "Group", CallKind.PRIVATE_VOICE:
                  "Private", CallKind.DATA: "Data", CallKind.CONTROL:
                  "Control", CallKind.ENCRYPTED: "Enc", CallKind.UNKNOWN:
                  "?"}
    for e in evs[-(height - 1):]:
        t = time.strftime("%H:%M:%S", time.localtime(e.when))
        end = e.ended if e.ended is not None else now
        dur = _fmt_dur(max(end - e.when, 0.0))
        info = e.text
        if getattr(e, "alias", ""):
            info = (f"[{e.alias}] " + info).rstrip()
        if getattr(e, "gps", ""):
            info = (info + f" @{e.gps}").strip()
        line = (f" {t} {kind_names.get(e.kind, '?'):<9}"
                f"{e.tg:<10d}{e.src:<11d}{e.slot:<3d}{dur:<8}{info}")
        rows.append(line[:width])
    return rows


def channel_grid_rows(channels: list[dict], width: int,
                      cell_w: int = 23) -> list[str]:
    """Fleet channel grid: ``channels`` is a list of dicts with keys
    id, freq_hz, state ('cc'|'voice'|'idle'|'mute'), tg (optional),
    rssi_db (optional).  Cells wrap to the terminal width."""
    per_row = max(width // cell_w, 1)
    glyph = {"cc": "C", "voice": "V", "idle": ".", "mute": "m"}
    rows = []
    line = ""
    for i, ch in enumerate(channels):
        st = glyph.get(ch.get("state", "idle"), "?")
        f_mhz = ch.get("freq_hz", 0.0) / 1e6
        tg = ch.get("tg", 0)
        cell = f"[{ch.get('id', i):>3}:{f_mhz:8.4f} {st}"
        cell += f" {tg:>5}]" if tg else "      ]"
        line += cell.ljust(cell_w)
        if (i + 1) % per_row == 0:
            rows.append(line[:width])
            line = ""
    if line:
        rows.append(line[:width])
    return rows


def channels_from_contexts(ctxs, freqs=None) -> list[dict]:
    """Adapter: per-channel DecoderContexts (the batched CC pipelines'
    ``ctxs``) → channel-grid dicts.  A channel shows 'voice' while its
    last events carry an active talkgroup, 'cc' when control traffic is
    flowing, else 'idle'."""
    out = []
    for i, ctx in enumerate(ctxs):
        st = "idle"
        tg = getattr(ctx.state, "last_tg", 0) or 0
        if ctx.events:
            tail = ctx.events[-8:]
            if any("VOICE" in e.line or "4V" in e.line for e in tail):
                st = "voice"
            elif any(("TSBK" in e.line) or ("CSBK" in e.line)
                     or ("TSDU" in e.line) for e in tail):
                st = "cc"
        out.append({"id": i, "state": st, "tg": tg if st == "voice" else 0,
                    "freq_hz": (freqs[i] if freqs is not None else 0.0)})
    return out


def history_from_events(events, fs_sym: float = 4800.0,
                        t0: float | None = None):
    """Adapter: decode events (DecodeEvent list) → an EventHistory for
    the call-history pane.  Grant/voice/release events become call
    begin/end markers with symbol positions converted to stream time.
    ``t0`` anchors the wall-clock origin; pass 0.0 to keep CallEvent
    times in stream seconds (the HTTP frontend's /calls view)."""
    from dsdneo_tpu_torch.core.events import CallEvent, CallKind, EventHistory
    h = EventHistory(slots=2)
    t0 = time.time() if t0 is None else t0
    for e in events:
        when = t0 + e.pos / fs_sym
        f = e.fields
        slot = int(f.get("slot", 0) or 0) % 2
        if "grant" in f or "trunk_grant" in f:
            h.begin_call(CallEvent(when, e.protocol, CallKind.GROUP_VOICE,
                                   slot=slot, tg=int(f.get("tg", 0) or 0),
                                   src=int(f.get("src", 0) or 0),
                                   freq_hz=float(f.get("freq_hz", 0) or 0)))
        elif "VOICE" in e.line or "4V" in e.line or "voice" in f:
            if h.active.get(slot) is None:
                h.begin_call(CallEvent(when, e.protocol,
                                       CallKind.GROUP_VOICE, slot=slot,
                                       tg=int(f.get("tg", 0) or 0),
                                       src=int(f.get("src", 0) or 0)))
        elif f.get("release") or "Call End" in e.line:
            h.end_call(slot, when=when)
        elif "Talker Alias:" in e.line:
            # late alias enrichment rides the call epoch it keyed
            act = h.active.get(slot)
            if act is not None:
                h.enrich_alias(slot, act.epoch, e.line.split(
                    "Talker Alias:", 1)[1].strip().rstrip(";"))
        elif "GPS:" in e.line:
            act = h.active.get(slot)
            if act is not None:
                h.enrich_gps(slot, act.epoch, e.line.split(
                    "GPS:", 1)[1].strip().rstrip(";"))
    return h


def protocol_status_rows(state, mode: str, width: int) -> list[str]:
    """Per-protocol current-state summary (the reference printer's main
    status region, dsd_ncurses_printer.c): identity, active call, crypto
    state — whatever the decode context has populated."""
    rows = []
    tg = getattr(state, "last_tg", 0) or 0
    src = getattr(state, "last_src", 0) or 0
    rows.append(f" MODE {mode:<8}  TG {tg:<10d} SRC {src:<10d}"[:width])
    nac = getattr(state, "nac", 0) or 0
    if nac:
        rows.append(f" P25  NAC {nac:03X}"[:width])
    alg = getattr(state, "payload_algid", 0) or 0
    if alg and alg != 0x80:
        kid = getattr(state, "payload_kid", 0) or 0
        mi = getattr(state, "payload_mi", 0) or 0
        rows.append(f" ENC  ALG {alg:02X}  KID {kid:04X}  MI {mi:016X}"
                    [:width])
    cc = getattr(state, "dmr_color_code", None)
    if cc is not None:
        rows.append(f" DMR  Color Code {cc}"[:width])
    ran = getattr(state, "nxdn_ran", None)
    if ran is not None:
        rows.append(f" NXDN RAN {ran}"[:width])
    alias = getattr(state, "talker_alias", "") or ""
    if alias:
        rows.append(f" ALIAS {alias}"[:width])
    gps = getattr(state, "last_gps", None)
    if gps:
        rows.append(f" GPS  {gps}"[:width])
    kr = getattr(state, "keyring", None)
    if kr is not None:
        n = len(getattr(kr, "scalar", {}) or {}) \
            + len(getattr(kr, "aes", {}) or {})
        forced = getattr(kr, "forced", None)
        rows.append(f" KEYS {n} loaded"
                    + (" + forced" if forced is not None else ""))
    return rows


def protocol_detail_rows(state, events, mode: str,
                         width: int, height: int = 14) -> list[str]:
    """Per-protocol deep-detail pane (the reference printer's
    protocol-specific regions, src/ui/terminal/dsd_ncurses_printer.c):
    site/system identity, channel plans, neighbors, branding, per-slot
    activity — derived from decode-context state plus the recent event
    ring.  ``events`` may be None (state-only view)."""
    rows: list[str] = []
    evs = list(events or [])[-200:]
    fam = mode.split("_")[0] if mode else ""

    def _recent(pred, n=4):
        out = []
        for e in reversed(evs):
            if pred(e) and e.line.strip() not in out:
                out.append(e.line.strip())
                if len(out) >= n:
                    break
        return list(reversed(out))

    if fam.startswith("p25") or fam in ("cqpsk", "x2"):
        nac = getattr(state, "nac", 0) or 0
        wacn = getattr(state, "p2_wacn", 0) or 0
        sysid = getattr(state, "p2_sysid", 0) or 0
        rf = getattr(state, "p2_rfssid", 0) or 0
        site = getattr(state, "p2_siteid", 0) or 0
        rows.append(f" P25  NAC {nac:03X}  WACN {wacn:05X}  SYS {sysid:03X}"
                    f"  RFSS {rf:03d}  SITE {site:03d}")
        it = getattr(state, "iden_table", None)
        if it is not None and getattr(it, "entries", None):
            for iden, (base, spacing, off, slots) in sorted(
                    it.entries.items())[:4]:
                rows.append(f" IDEN {iden:X}: base {base/1e6:9.4f} MHz"
                            f"  step {spacing/1e3:5.2f} kHz  slots {slots}")
        nb = []
        for e in reversed(evs):
            for cht in e.fields.get("neighbors", []) or []:
                if cht not in nb:
                    nb.append(cht)
        if nb:
            rows.append(" NEIGHBORS " + " ".join(f"{c:04X}" for c in nb[:6]))
        rows += _recent(lambda e: "RFSS" in e.line or "Network Stat"
                        in e.line or "Adjacent" in e.line, 3)
    elif fam == "dmr":
        cc = getattr(state, "dmr_color_code", -1)
        brand = getattr(state, "dmr_branding", "") or ""
        rows.append(f" DMR  CC {cc if cc >= 0 else '--'}  {brand}".rstrip())
        parms = getattr(state, "dmr_site_parms", "") or ""
        if parms:
            rows.append(f" SITE {parms}")
        rest = getattr(state, "dmr_rest_channel", None)
        if rest is not None:
            rows.append(f" REST CHANNEL {rest}")
        for s in (0, 1):
            last = next((e for e in reversed(evs)
                         if int(e.fields.get("slot", -1) or 0) == s
                         and (e.fields.get("tg") or e.fields.get("src"))),
                        None)
            if last is not None:
                rows.append(f" SLOT {s + 1}  TG {last.fields.get('tg', 0)}"
                            f"  SRC {last.fields.get('src', 0)}")
        rows += _recent(lambda e: "C_BCAST" in e.line
                        or "ALOHA" in e.line, 2)
    elif fam.startswith("nxdn"):
        ran = getattr(state, "nxdn_ran", -1)
        rows.append(f" NXDN RAN {ran if ran >= 0 else '--'}"
                    f"  TG {getattr(state, 'last_tg', 0) or 0}"
                    f"  SRC {getattr(state, 'last_src', 0) or 0}")
        alias = getattr(state, "last_alias", "") or ""
        if alias:
            rows.append(f" ALIAS {alias}")
        rows += _recent(lambda e: "Site" in e.line or "CCH" in e.line, 3)
    elif fam == "edacs":
        grants = [e for e in evs if e.fields.get("afs")]
        if grants:
            rows.append(" EDACS recent calls (AFS):")
            for e in grants[-4:]:
                rows.append(f"  {e.fields.get('afs')}  "
                            f"LCN {e.fields.get('lcn', '?')}")
        rows += _recent(lambda e: "Site" in e.line or "ESK" in e.line, 2)
    elif fam == "m17":
        sig = getattr(state, "m17_sig_status", "") or ""
        if sig:
            rows.append(f" M17  {sig}")
        gps = getattr(state, "m17_gps", "") or ""
        if gps:
            rows.append(f" GPS  {gps}")
        last = next((e for e in reversed(evs)
                     if e.fields.get("dst") or e.fields.get("src")), None)
        if last is not None:
            rows.append(f" LSF  DST {last.fields.get('dst', '')}  "
                        f"SRC {last.fields.get('src', '')}")
    elif fam == "dstar":
        txt = getattr(state, "dstar_text", "") or ""
        if txt:
            rows.append(f" DSTAR TEXT {txt}")
        gps = getattr(state, "dstar_gps", "") or ""
        if gps:
            rows.append(f" DPRS {gps}")
        rows += _recent(lambda e: "RPT" in e.line or "UR" in e.line, 3)
    elif fam == "ysf":
        rows += _recent(lambda e: "DCH" in e.line or "CSD" in e.line
                        or "Dest" in e.line, 4)

    if not rows:
        rows = [f" (no {mode or 'protocol'} detail yet)"]
    return [r[:width] for r in rows[:height]]


def live_status_rows(snap, width: int) -> list[str]:
    """Live-engine status pane from a FrontendMetrics snapshot
    (app_control.snapshot): RF + ring + decode-health block, the
    reference printer's top region for the RTL input."""
    h = snap.health
    ok = h.p25p1_fec_ok + h.dmr_fec_ok + h.generic_crc_ok
    err = h.p25p1_fec_err + h.dmr_fec_err + h.generic_crc_err
    rows = [
        f" FREQ {snap.freq_hz/1e6:10.5f} MHz   SNR {snap.snr_db:5.1f} dB"
        f"   CFO {snap.cfo_hz:+6.0f} Hz",
        f" BLOCKS {snap.blocks:<8d} RETUNES {snap.retunes:<4d}"
        f" RING {snap.ring_fill}/{snap.ring_drops} fill/drops"
        + ("  [MUTED]" if snap.retune_muted else ""),
        f" FEC  ok {ok}  err {err}   gen {snap.generation}",
    ]
    return [r[:width] for r in rows]


def trunk_status_rows(state, width: int) -> list[str]:
    """Site / trunking pane from decode-context state: identity, iden
    table, affiliation + patch summary (reference printer site pane)."""
    rows = []
    wacn = getattr(state, "p2_wacn", 0)
    sysid = getattr(state, "p2_sysid", 0)
    nac = getattr(state, "nac", 0)
    rows.append(f" SYS  WACN {wacn:05X}  SYSID {sysid:03X}  NAC {nac:03X}"
                [:width])
    it = getattr(state, "iden_table", None)
    if it is not None and it.entries:
        for iden, (base, spacing, off, slots) in sorted(it.entries.items()):
            rows.append(f" IDEN {iden:X}: base {base/1e6:9.4f} MHz  "
                        f"spacing {spacing/1e3:5.1f} kHz  slots {slots}"
                        [:width])
    aff = getattr(state, "affiliations", None)
    if aff is not None:
        n_units = len(getattr(aff, "units", {}) or {})
        patches = getattr(aff, "patches", {}) or {}
        rows.append(f" AFF  {n_units} units registered; "
                    f"{len(patches)} patch/simulselect groups"[:width])
        for sg, p in list(sorted(patches.items()))[:4]:
            wg = ",".join(str(w) for w in sorted(p.get("wgids", []))[:4])
            rows.append(f"  SG {sg}: {'patch' if p.get('is_patch') else 'sim'}"
                        f" {'on' if p.get('active') else 'off'} [{wg}]"
                        [:width])
    return rows
