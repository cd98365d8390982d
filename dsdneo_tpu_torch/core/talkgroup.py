"""Talkgroup policy: allow/block/hold/preempt + CSV imports.

Reference parity: src/core/util/talkgroup_policy.c (allow/block with
modes, TG hold per slot, encrypted lockout) and src/core/file/
dsd_import.c (group list / channel map / key CSV formats per
docs/csv-formats.md).

The port's own copy of ``dsdneo_tpu/core/talkgroup.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from typing import Optional


_TRUTHY = ("true", "yes", "on", "1")


@dataclass
class GroupEntry:
    tg: int
    mode: str = "A"        # A=allow, B=block, DE=block-when-encrypted
    label: str = ""
    # extended policy columns (docs/csv-formats.md:115-131, opt-in via
    # a header whose 4th column is `priority`): higher priority wins;
    # preempt=true lets its grants displace an active lower-priority
    # call; audio/record/stream gate the media paths (mode B/DE and
    # audio=off force media off)
    priority: int = 0
    preempt: bool = False
    audio: bool = True
    record: bool = True
    stream: bool = True


@dataclass
class TalkgroupPolicy:
    groups: dict[int, GroupEntry] = field(default_factory=dict)
    whitelist_mode: bool = False    # only allow listed TGs
    tg_hold: dict[int, int] = field(default_factory=dict)  # slot -> tg
    enc_lockout: bool = False

    # -- decisions --------------------------------------------------------
    def allows(self, tg: int, slot: int = 0, encrypted: bool = False) -> bool:
        hold = self.tg_hold.get(slot, 0)
        if hold and tg != hold:
            return False
        ent = self.groups.get(tg)
        if ent is None:
            return not self.whitelist_mode
        if ent.mode.upper().startswith("B"):
            return False
        if encrypted and (self.enc_lockout or ent.mode.upper() == "DE"):
            return False
        return True

    def label(self, tg: int) -> str:
        ent = self.groups.get(tg)
        return ent.label if ent else ""

    def hold(self, slot: int, tg: int) -> None:
        self.tg_hold[slot] = tg

    def release_hold(self, slot: int) -> None:
        self.tg_hold.pop(slot, None)

    # -- CSV import (group.csv: TG,Mode,Label) ----------------------------
    def import_group_csv(self, path: str) -> int:
        n = 0
        extended = False
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                head = row[0].strip().lower()
                if head in ("tg", "talkgroup", "#", "id", "dec"):
                    # extended policy parsing is enabled only when the
                    # header opts in with `priority` in column 4
                    # (docs/csv-formats.md:124)
                    extended = (len(row) > 3
                                and row[3].strip().lower() == "priority")
                    continue
                ids = self._parse_id_field(row[0])
                if not ids:
                    continue
                mode = (row[1].strip() if len(row) > 1 else "A") or "A"
                label = row[2].strip() if len(row) > 2 else ""
                kw = {}
                if extended:
                    def _col(i, default=""):
                        return row[i].strip() if len(row) > i else default
                    try:
                        kw["priority"] = max(0, min(100, int(_col(3, "0") or 0)))
                    except ValueError:
                        pass
                    kw["preempt"] = _col(4).lower() in _TRUTHY
                    audio = _col(5).lower()
                    kw["audio"] = audio in _TRUTHY if audio else True
                    rec = _col(6).lower()
                    kw["record"] = rec in _TRUTHY if rec else True
                    strm = _col(7).lower()
                    kw["stream"] = strm in _TRUTHY if strm else True
                    # audio=off forces record/stream off; B/DE modes
                    # force all media off (csv-formats.md:133-134)
                    if not kw["audio"] or mode.upper() in ("B", "DE"):
                        kw["record"] = kw["stream"] = False
                        if mode.upper() in ("B", "DE"):
                            kw["audio"] = False
                for tg in ids:
                    if tg not in self.groups:   # first match wins
                        self.groups[tg] = GroupEntry(tg, mode, label, **kw)
                        n += 1
        return n

    @staticmethod
    def _parse_id_field(raw: str) -> list[int]:
        """Exact decimal ID or an inclusive `lo-hi` range row
        (docs/csv-formats.md:126-129); bad rows → []."""
        raw = raw.strip()
        if "-" in raw[1:]:
            lo, _, hi = raw.partition("-")
            try:
                a, b = int(lo), int(hi)
            except ValueError:
                return []
            if 0 <= a <= b and b - a <= 100_000:
                return list(range(a, b + 1))
            return []
        try:
            return [int(raw)]
        except ValueError:
            return []

    def priority(self, tg: int) -> int:
        ent = self.groups.get(tg)
        return ent.priority if ent else 0

    def preempts(self, tg: int) -> bool:
        ent = self.groups.get(tg)
        return bool(ent and ent.preempt)
