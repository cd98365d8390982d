"""Curses terminal frontend: live decode status, event scroller,
symbol-eye visualizer.

Reference parity: the ncurses frontend family (src/ui/terminal/ —
ui_async.c lifecycle, dsd_ncurses_printer.c status panes,
ncurses_visualizers.c eye/constellation views), reduced to the
capture-replay workflow: a header pane (mode, sync counts, call state),
a scrolling event log, and an ASCII eye diagram of the recovered
symbols.

The port's own copy of ``dsdneo_tpu/ui/terminal.py`` (host Python,
curses), unchanged in its logic.
"""

from __future__ import annotations

import curses
from dataclasses import dataclass


@dataclass
class UiModel:
    mode: str = ""
    source: str = ""
    n_events: int = 0
    n_syncs: int = 0
    audio_s: float = 0.0
    lines: list = None
    soft: object = None     # np array of normalized symbols (optional)
    iq: object = None       # complex samples (optional, for const/spectrum)
    history: object = None  # core.events.EventHistory (call-history pane)
    channels: list = None   # channel-grid dicts (ui.panes.channel_grid_rows)
    state: object = None    # decode-context state (trunking site pane)
    events: list = None     # DecodeEvent ring (per-protocol detail pane)


def _eye_rows(soft, width: int, height: int = 7) -> list[str]:
    import numpy as np
    if soft is None or len(soft) < width:
        return []
    m = (min(len(soft), width * 4) // 4) * 4   # whole groups of 4 only
    if m == 0:
        return []
    seg = np.asarray(soft[:m]).reshape(-1, 4).mean(axis=1)[:width]
    rows = []
    levels = np.linspace(3.5, -3.5, height)
    for lv in levels:
        row = "".join("*" if abs(s - lv) < 0.5 else " " for s in seg)
        rows.append(row)
    return rows


def _histogram_rows(soft, width: int, height: int = 7) -> list[str]:
    """Symbol-level histogram (the reference's FSK histogram view)."""
    import numpy as np
    if soft is None or len(soft) < 64:
        return []
    s = np.asarray(soft)
    hist, _ = np.histogram(np.clip(s, -4, 4), bins=min(width, 64),
                           range=(-4, 4))
    hist = hist / max(hist.max(), 1)
    rows = []
    for r in range(height):
        thr = 1.0 - (r + 0.5) / height
        rows.append("".join("#" if v >= thr else " " for v in hist))
    return rows


def _constellation_rows(iq, width: int, height: int = 7) -> list[str]:
    """ASCII I/Q scatter (reference ncurses_visualizers.c constellation)."""
    import numpy as np
    if iq is None or len(iq) < 64:
        return []
    z = np.asarray(iq)[:4096]
    scale = max(float(np.percentile(np.abs(z), 95)), 1e-6)
    xi = np.clip(((z.real / scale) + 1) * 0.5 * (width - 1), 0, width - 1)
    yi = np.clip(((-z.imag / scale) + 1) * 0.5 * (height - 1), 0, height - 1)
    grid = np.zeros((height, width), dtype=np.int64)
    np.add.at(grid, (yi.astype(int), xi.astype(int)), 1)
    glyphs = " .:*#"
    mx = max(grid.max(), 1)
    return ["".join(glyphs[min(int(v * 4 / mx + (v > 0)), 4)] for v in row)
            for row in grid]


def _spectrum_rows(iq, width: int, height: int = 7) -> list[str]:
    """Log-magnitude spectrum bars (reference spectrum snapshot view)."""
    import numpy as np
    if iq is None or len(iq) < 256:
        return []
    z = np.asarray(iq)[:16384]
    n = 1 << int(np.log2(len(z)))
    spec = np.fft.fftshift(np.abs(np.fft.fft(z[:n])))
    bins = np.array_split(spec, width)
    db = np.array([20 * np.log10(max(float(b.mean()), 1e-9)) for b in bins])
    db -= db.max()
    db = np.clip(db / 50.0 + 1.0, 0, 1)      # 50 dB range
    rows = []
    for r in range(height):
        thr = 1.0 - (r + 0.5) / height
        rows.append("".join("|" if v >= thr else " " for v in db))
    return rows


_VIEWS = ("eye", "histogram", "constellation", "spectrum", "calls",
          "grid", "trunk", "status", "detail")


def _view_rows(model: UiModel, view: str, width: int) -> list[str]:
    from dsdneo_tpu_torch.ui import panes
    if view == "eye":
        return _eye_rows(model.soft, width)
    if view == "histogram":
        return _histogram_rows(model.soft, width)
    if view == "constellation":
        return _constellation_rows(model.iq, width)
    if view == "calls":
        if model.history is None:
            return [" (no call history)"]
        return panes.call_history_rows(model.history, width)
    if view == "grid":
        if not model.channels:
            return [" (no channels)"]
        return panes.channel_grid_rows(model.channels, width)
    if view == "trunk":
        if model.state is None:
            return [" (no trunk state)"]
        return panes.trunk_status_rows(model.state, width)
    if view == "status":
        if model.state is None:
            return [" (no decoder state)"]
        return panes.protocol_status_rows(model.state, model.mode, width)
    if view == "detail":
        if model.state is None:
            return [" (no decoder state)"]
        return panes.protocol_detail_rows(model.state, model.events,
                                          model.mode, width)
    return _spectrum_rows(model.iq, width)


def _wrapped(main, *args) -> bool:
    """``curses.wrapper(main, *args)``; False when curses found no
    terminal to draw on (``TERM`` unset or unknown), so nothing was
    drawn.  A curses error raised once the screen is up propagates."""
    up = []

    def body(scr):
        up.append(True)
        main(scr, *args)
    try:
        curses.wrapper(body)
    except curses.error:
        if up:
            raise
        return False
    return True


def run(model: UiModel, max_idle_polls: int | None = None,
        queue=None) -> bool:
    """Blocking curses browser over a decoded capture (q quits,
    arrows/PgUp/PgDn scroll, m opens the menu).  When stdin is not a
    tty the view renders and exits after a short idle period
    (headless/CI replay).  ``queue`` is the app_control CommandQueue
    that menu actions are sent to.  Returns False, having drawn
    nothing, when curses finds no terminal."""
    import sys
    if max_idle_polls is None and not sys.stdin.isatty():
        max_idle_polls = 10
    return _wrapped(_main, model, max_idle_polls, queue)


def _main(scr, model: UiModel, max_idle_polls: int | None = None,
          queue=None) -> None:
    from dsdneo_tpu_torch.ui.menu import MenuState
    menu = MenuState(queue=queue)
    try:
        curses.curs_set(0)
    except curses.error:
        pass
    scr.timeout(100)
    offset = max(len(model.lines or []) - 1, 0)
    idle = 0
    view_idx = 0
    while True:
        h, w = scr.getmaxyx()
        scr.erase()
        head = (f" dsd-neo-tpu | mode {model.mode} | {model.source} | "
                f"events {model.n_events} | syncs {model.n_syncs} | "
                f"audio {model.audio_s:.1f}s | view {_VIEWS[view_idx]} ")
        scr.addnstr(0, 0, head.ljust(w), w - 1, curses.A_REVERSE)

        eye = _view_rows(model, _VIEWS[view_idx], min(w - 2, 120))
        y = 1
        for row in eye:
            if y >= h - 1:
                break
            scr.addnstr(y, 1, row, w - 2)
            y += 1
        if eye:
            scr.addnstr(y, 1, "-" * min(w - 2, 120), w - 2)
            y += 1

        lines = model.lines or []
        view_h = h - y - 1
        start = max(min(offset, len(lines) - view_h), 0)
        for i, line in enumerate(lines[start:start + view_h]):
            scr.addnstr(y + i, 0, line.replace("\n", " | "), w - 1)
        # menu overlay (data-driven, non-blocking; reference menu_core.c)
        for i, row in enumerate(menu.render_rows(min(44, w - 4))):
            if 2 + i < h - 1:
                scr.addnstr(2 + i, 2, row, w - 3, curses.A_REVERSE)
        foot = (f" {menu.status} " if menu.status else
                " q quit   m menu   v view   ↑/↓ PgUp/PgDn scroll ")
        scr.addnstr(h - 1, 0, foot.ljust(w - 1), w - 1, curses.A_REVERSE)
        scr.refresh()
        ch = scr.getch()
        if ch == -1:
            idle += 1
            if max_idle_polls is not None and idle >= max_idle_polls:
                break
            continue
        idle = 0
        if menu.handle_key(ch):
            continue
        if ch == ord("m"):
            menu.toggle()
        elif ch in (ord("q"), 27):
            break
        elif ch == ord("v"):
            view_idx = (view_idx + 1) % len(_VIEWS)
        elif ch == curses.KEY_UP:
            offset = max(offset - 1, 0)
        elif ch == curses.KEY_DOWN:
            offset += 1
        elif ch == curses.KEY_PPAGE:
            offset = max(offset - view_h, 0)
        elif ch == curses.KEY_NPAGE:
            offset += view_h


_LIVE_VIEWS = ("status", "eye", "spectrum", "calls")


def run_live(engine, duration: float = 0.0, events=None,
             max_idle_polls: int | None = None) -> bool:
    """Live curses frontend attached to a running LiveEngine: polls
    app_control metric snapshots per frame (the reference ui_async.c
    polling loop over dsd_frontend metrics), renders status / eye /
    spectrum panes from the published visualizer buffers, scrolls the
    decode-event tail, and routes menu actions into the engine's
    CommandQueue (tune/squelch/gain/mute reach the engine between
    blocks, like app_command_queue.c).  Returns False, having drawn
    nothing, when curses finds no terminal: the engine is left running
    without a frontend, as the reference's -N fallback runs it."""
    import sys
    if max_idle_polls is None and not sys.stdin.isatty():
        max_idle_polls = 20
    return _wrapped(_main_live, engine, duration,
                    events if events is not None else [], max_idle_polls)


def _main_live(scr, engine, duration, events, max_idle_polls):
    import time as _t
    from dsdneo_tpu_torch.ui import panes
    from dsdneo_tpu_torch.ui.menu import MenuState
    menu = MenuState(queue=engine.commands)
    try:
        curses.curs_set(0)
    except curses.error:
        pass
    scr.timeout(250)
    t0 = _t.time()
    idle = 0
    view_idx = 0
    while True:
        if duration > 0 and _t.time() - t0 >= duration:
            break
        if getattr(engine, "_stop", False):
            break
        snap = engine.metrics.snapshot()
        h, w = scr.getmaxyx()
        scr.erase()
        head = (f" dsd-neo-tpu LIVE | {engine.mode} | "
                f"{snap.freq_hz/1e6:.4f} MHz | blk {snap.blocks} | "
                f"view {_LIVE_VIEWS[view_idx]} ")
        scr.addnstr(0, 0, head.ljust(w), w - 1, curses.A_REVERSE)
        view = _LIVE_VIEWS[view_idx]
        if view == "status":
            rows = panes.live_status_rows(snap, min(w - 2, 120))
        elif view == "eye":
            rows = _eye_rows(snap.eye_symbols, min(w - 2, 120))
        elif view == "calls":
            hist = getattr(engine, "history", None)
            rows = (panes.call_history_rows(hist, min(w - 2, 120))
                    if hist is not None else [" (no call history)"])
        else:
            rows = _db_bar_rows(snap.spectrum_db, min(w - 2, 120))
        y = 1
        for row in rows:
            if y >= h - 2:
                break
            scr.addnstr(y, 1, row, w - 2)
            y += 1
        scr.addnstr(y, 1, "-" * min(w - 2, 120), w - 2)
        y += 1
        tail = list(events)[-(h - y - 1):]
        for i, line in enumerate(tail):
            scr.addnstr(y + i, 0, str(line).replace("\n", " | "), w - 1)
        for i, row in enumerate(menu.render_rows(min(44, w - 4))):
            if 2 + i < h - 1:
                scr.addnstr(2 + i, 2, row, w - 3, curses.A_REVERSE)
        foot = (f" {menu.status} " if menu.status else
                " q quit   m menu   v view ")
        scr.addnstr(h - 1, 0, foot.ljust(w - 1), w - 1, curses.A_REVERSE)
        scr.refresh()
        ch = scr.getch()
        if ch == -1:
            idle += 1
            if max_idle_polls is not None and idle >= max_idle_polls:
                break
            continue
        idle = 0
        if menu.handle_key(ch):
            continue
        if ch == ord("m"):
            menu.toggle()
        elif ch in (ord("q"), 27):
            break
        elif ch == ord("v"):
            view_idx = (view_idx + 1) % len(_LIVE_VIEWS)


def _db_bar_rows(db, width: int, height: int = 7) -> list[str]:
    """Bars from an already-computed spectrum_db snapshot buffer."""
    import numpy as np
    if db is None or len(db) < 8:
        return [" (no spectrum yet)"]
    d = np.asarray(db, dtype=np.float32)
    bins = np.array_split(d, min(width, len(d)))
    v = np.array([float(b.mean()) for b in bins])
    v -= v.max()
    v = np.clip(v / 50.0 + 1.0, 0, 1)
    return ["".join("|" if x >= 1.0 - (r + 0.5) / height else " "
                    for x in v) for r in range(height)]
