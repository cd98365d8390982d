"""P25 affiliation + patch/supergroup tracking.

Registries the control-channel handlers feed and the UI/event layer
reads: unit registrations, radio→talkgroup affiliations, and dynamic
regroup (patch) supergroups with their member WGIDs/WUIDs.  Reference
parity: src/protocol/p25/p25_aff.c (p25_aff_register / p25_ga_add) and
p25_patch.c (p25_patch_update / add_wgid / add_wuid / clear_sg), fed
from the same message set (group affiliation responses, unit
registration responses, Motorola group regroup extended functions,
MFID90 regroup add/delete LCWs).

The port's own copy of ``dsdneo_tpu/core/affiliation.py`` (numpy only), unchanged in its
logic, so both packages give the same results bit for bit.
"""

from __future__ import annotations

from collections import OrderedDict


class AffiliationTable:
    """Bounded MRU registries (the reference caps its arrays too)."""

    def __init__(self, cap: int = 512):
        self.cap = cap
        self.units: OrderedDict[int, bool] = OrderedDict()
        self.groups: OrderedDict[int, set] = OrderedDict()   # rid → {tg}
        self.patches: dict[int, dict] = {}                   # sg → info

    # -- unit registration / group affiliation ----------------------------
    def register(self, rid: int) -> None:
        if not rid:
            return
        self.units[rid] = True
        self.units.move_to_end(rid)
        while len(self.units) > self.cap:
            self.units.popitem(last=False)

    def affiliate(self, rid: int, tg: int) -> None:
        if not rid or not tg:
            return
        self.register(rid)
        self.groups.setdefault(rid, set()).add(tg)
        self.groups.move_to_end(rid)
        while len(self.groups) > self.cap:
            self.groups.popitem(last=False)

    def affiliated_units(self, tg: int) -> list[int]:
        return [rid for rid, tgs in self.groups.items() if tg in tgs]

    # -- patches / supergroups (dynamic regroup) --------------------------
    def _patch_entry(self, sg: int) -> dict:
        """Create-if-absent with defaults; adds never overwrite the
        flags of an existing entry (reference p25_patch_add_wgid)."""
        return self.patches.setdefault(
            sg, {"is_patch": True, "active": True,
                 "wgids": set(), "wuids": set()})

    def patch_update(self, sg: int, is_patch: bool = True,
                     active: bool = True) -> None:
        if not sg:
            return
        p = self._patch_entry(sg)
        p["is_patch"], p["active"] = is_patch, active

    def patch_add_wgid(self, sg: int, wgid: int) -> None:
        if sg and wgid:
            self._patch_entry(sg)["wgids"].add(wgid)

    def patch_add_wuid(self, sg: int, wuid: int) -> None:
        if sg and wuid:
            self._patch_entry(sg)["wuids"].add(wuid)

    def patch_set_kas(self, sg: int, key: int = -1, alg: int = -1,
                      ssn: int = -1) -> None:
        """Key/algorithm/SSN for encrypted regroups (reference
        p25_patch.c:377-398 p25_patch_set_kas; negative = leave as-is)."""
        if not sg:
            return
        p = self._patch_entry(sg)
        if key >= 0:
            p["key"] = key
        if alg >= 0:
            p["alg"] = alg
        if ssn >= 0:
            p["ssn"] = ssn & 0x1F

    def patch_remove_wgid(self, sg: int, wgid: int) -> None:
        p = self.patches.get(sg)
        if p is not None:
            p["wgids"].discard(wgid)

    def patch_clear(self, sg: int) -> None:
        self.patches.pop(sg, None)

    def patch_summary(self) -> str:
        out = []
        for sg, p in self.patches.items():
            if not p["active"]:
                continue
            kind = "P" if p["is_patch"] else "SS"
            members = sorted(p["wgids"]) + [f"u{u}" for u in
                                           sorted(p["wuids"])]
            out.append(f"{kind}:{sg}[" + ",".join(map(str, members)) + "]")
        return " ".join(out)


def table_for(ctx) -> AffiliationTable:
    """Per-context lazy registry (ctx.state.affiliations)."""
    t = getattr(ctx.state, "affiliations", None)
    if t is None:
        t = AffiliationTable()
        ctx.state.affiliations = t
    return t
