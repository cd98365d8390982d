"""The last step of ``correct``: every number a cell's reference
computes (``portbench/reference/``) held to the limit its configuration
file states (``limits``)."""

from __future__ import annotations


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number with no limit, or a limit with no number, fails."""
    out = {}
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not (v <= lim):
            ok = False
    return ok, out
