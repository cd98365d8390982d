"""Data-driven, non-blocking menu system for the terminal frontend.

The reference drives its ncurses menus from static item tables with
per-item action callbacks, polled without blocking the decode thread
(src/ui/terminal/menu_core.c, menu services in menu_*.c); commands
reach the engine through the app_control queue
(src/app_control/app_command_queue.c).  This is the same shape: a
`MenuItem` tree (submenu / action / toggle / input), a pure
`MenuState` machine that consumes key codes and renders text rows —
fully testable without curses — and an `AppCommand` queue sink.

The port's own copy of ``dsdneo_tpu/ui/menu.py`` (host Python),
unchanged in its logic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from dsdneo_tpu_torch.app_control.commands import AppCommand, CommandQueue

KEY_UP, KEY_DOWN, KEY_LEFT, KEY_RIGHT = 259, 258, 260, 261
KEY_ENTER, KEY_ESC, KEY_BACKSPACE = 10, 27, 263


@dataclass
class MenuItem:
    label: str
    command: AppCommand | None = None
    payload: Any = None                   # fixed payload for actions
    children: list["MenuItem"] = field(default_factory=list)
    prompt: str = ""                      # non-empty -> input item
    parse: Callable[[str], Any] | None = None
    value: Callable[[], str] | None = None   # current-value display

    @property
    def kind(self) -> str:
        if self.children:
            return "submenu"
        if self.prompt:
            return "input"
        return "action"


def default_menu(modes: list[str] | None = None) -> list[MenuItem]:
    """The reference's menu surface: tuning, decode mode, audio,
    trunking, exit (menu_*.c services)."""
    modes = modes or ["auto", "p25p1", "p25p2", "dmr", "nxdn48", "nxdn96",
                      "dstar", "dpmr", "ysf", "m17", "edacs", "provoice",
                      "x2tdma"]
    return [
        MenuItem("Tuning", children=[
            MenuItem("Set frequency (MHz)", prompt="freq MHz: ",
                     command=AppCommand.TUNE,
                     parse=lambda s: float(s) * 1e6),
            MenuItem("Set PPM", prompt="ppm: ", command=AppCommand.SET_PPM,
                     parse=int),
        ]),
        MenuItem("Decode", children=[
            MenuItem("Mode", children=[
                MenuItem(m, command=AppCommand.SET_MODE, payload=m)
                for m in modes]),
            MenuItem("Squelch (dB)", prompt="squelch dB: ",
                     command=AppCommand.SET_SQUELCH, parse=float),
        ]),
        MenuItem("Audio", children=[
            MenuItem("Toggle mute", command=AppCommand.TOGGLE_MUTE),
            MenuItem("Gain +", command=AppCommand.GAIN_DELTA, payload=+1),
            MenuItem("Gain -", command=AppCommand.GAIN_DELTA, payload=-1),
        ]),
        MenuItem("Trunking", children=[
            MenuItem("Hold talkgroup", prompt="tg: ",
                     command=AppCommand.TG_HOLD,
                     parse=lambda s: (0, int(s))),
            MenuItem("Release hold", command=AppCommand.TG_RELEASE,
                     payload=0),
        ]),
        MenuItem("Stop decoder", command=AppCommand.STOP),
    ]


class MenuState:
    """Pure key-driven menu machine; render_rows() gives the overlay."""

    def __init__(self, root: list[MenuItem] | None = None,
                 queue: CommandQueue | None = None):
        self.root = root if root is not None else default_menu()
        # note: CommandQueue defines __len__, so an empty queue is falsy
        self.queue = queue if queue is not None else CommandQueue()
        self.open = False
        self._path: list[tuple[list[MenuItem], int]] = []
        self._input_item: MenuItem | None = None
        self._input_buf = ""
        self.status = ""

    # -- navigation ---------------------------------------------------------
    def toggle(self) -> None:
        self.open = not self.open
        self._path = [(self.root, 0)] if self.open else []
        self._input_item = None
        self.status = ""

    @property
    def _items(self) -> list[MenuItem]:
        return self._path[-1][0]

    @property
    def _sel(self) -> int:
        return self._path[-1][1]

    def _set_sel(self, i: int) -> None:
        items, _ = self._path[-1]
        self._path[-1] = (items, i % len(items))

    def handle_key(self, ch: int) -> bool:
        """Returns True when the key was consumed by the menu."""
        if not self.open:
            return False
        if self._input_item is not None:
            return self._handle_input_key(ch)
        if ch == KEY_UP:
            self._set_sel(self._sel - 1)
        elif ch == KEY_DOWN:
            self._set_sel(self._sel + 1)
        elif ch in (KEY_LEFT, KEY_ESC):
            self._path.pop()
            if not self._path:
                self.open = False
        elif ch in (KEY_ENTER, 13, KEY_RIGHT):
            self._activate(self._items[self._sel])
        else:
            return False
        return True

    def _activate(self, item: MenuItem) -> None:
        if item.kind == "submenu":
            self._path.append((item.children, 0))
        elif item.kind == "input":
            self._input_item = item
            self._input_buf = ""
        else:
            self.queue.put(item.command, item.payload)
            self.status = f"sent {item.command.value}"
            self.open = False
            self._path = []

    def _handle_input_key(self, ch: int) -> bool:
        item = self._input_item
        if ch == KEY_ESC:
            self._input_item = None
        elif ch in (KEY_ENTER, 13):
            try:
                payload = (item.parse or str)(self._input_buf)
            except ValueError:
                self.status = f"bad value: {self._input_buf!r}"
                self._input_item = None
                return True
            self.queue.put(item.command, payload)
            self.status = f"sent {item.command.value} {payload}"
            self._input_item = None
            self.open = False
            self._path = []
        elif ch in (KEY_BACKSPACE, 127, 8):
            self._input_buf = self._input_buf[:-1]
        elif 32 <= ch < 127:
            self._input_buf += chr(ch)
        return True

    # -- rendering ----------------------------------------------------------
    def render_rows(self, width: int = 40) -> list[str]:
        if not self.open:
            return []
        if self._input_item is not None:
            return [f"{self._input_item.prompt}{self._input_buf}_"
                    .ljust(width)[:width]]
        rows = []
        for i, item in enumerate(self._items):
            mark = ">" if i == self._sel else " "
            tail = " >" if item.kind == "submenu" else (
                "…" if item.kind == "input" else "")
            val = f" [{item.value()}]" if item.value else ""
            rows.append(f"{mark} {item.label}{val}{tail}"
                        .ljust(width)[:width])
        return rows
