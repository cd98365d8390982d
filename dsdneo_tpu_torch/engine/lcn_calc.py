"""One-shot DMR Tier III LCN calculator.

Maps a list of voice-channel frequencies (one per CSV/text row) onto
logical channel numbers so a trunk-follower channel map can be built
before any control-channel CSBK traffic has been observed.  Mirrors the
reference one-shot mode (src/runtime/cli/oneshot_dmr_t3.c
dsd_cli_calc_dmr_t3_lcn_from_csv, wired via --calc-lcn in
src/runtime/cli/args.c:719,1126-1169):

* every input line containing an ASCII digit contributes its first
  numeric token; values < 1e5 are taken as MHz and scaled to Hz
  (oneshot_dmr_t3.c line_parse_frequency_hz)
* frequencies are sorted and deduplicated
* the channel step is either given explicitly or inferred as the
  smallest positive pairwise difference snapped to the 125 Hz grid
  (oneshot_dmr_t3.c infer_step_125)
* LCNs count up from the lowest frequency starting at ``start_lcn``
  (default 1), unless a control-channel anchor (cc_freq + cc_lcn) is
  supplied, in which case the base is aligned so that the anchor
  frequency receives exactly ``cc_lcn``
  (oneshot_dmr_t3.c resolve_base_lcn_with_anchor)

Exit codes follow the reference: 0 ok, 1 unreadable file, 2 no
frequencies parsed, 3 step could not be resolved.

The reference env knobs DSD_NEO_DMR_T3_{STEP_HZ,CC_FREQ,CC_LCN,
START_LCN} are honoured as fallbacks behind the CLI flags; CC_FREQ
follows the same <1e5 == MHz convention (runtime/config.cpp:775-785).

The port's own copy of ``dsdneo_tpu/engine/lcn_calc.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import os
import re
import sys
from typing import IO

_NUM = re.compile(r"[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


def parse_frequency_hz(line: str) -> int | None:
    """First numeric token of *line* as Hz (MHz if < 1e5), or None."""
    if not any(c.isdigit() for c in line):
        return None
    m = _NUM.search(line)
    if not m:
        return None
    try:
        val = float(m.group(0))
    except ValueError:
        return None
    hz = round(val * 1e6) if val < 1e5 else round(val)
    return hz if hz > 0 else None


def infer_step_125(freqs: list[int]) -> int:
    """Smallest positive adjacent difference snapped to 125 Hz."""
    best = 0
    for a, b in zip(freqs, freqs[1:]):
        d = b - a
        if d <= 0:
            continue
        r = round(d / 125) * 125
        if r > 0 and (best == 0 or r < best):
            best = r
    return best


def _env_int(name: str) -> int | None:
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        return int(v, 10)
    except ValueError:
        return None


def _env_freq_hz(name: str) -> int | None:
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        f = float(v)
    except ValueError:
        return None
    hz = round(f * 1e6) if f < 1e5 else round(f)
    return hz if hz > 0 else None


def calc_dmr_t3_lcn(
    path: str,
    *,
    step_hz: int | None = None,
    cc_freq_hz: int | None = None,
    cc_lcn: int | None = None,
    start_lcn: int | None = None,
    out: IO[str] | None = None,
) -> int:
    """Run the calculator; prints ``lcn,freq`` rows to *out* (stdout)."""
    out = out if out is not None else sys.stdout
    if step_hz is None:
        step_hz = _env_int("DSD_NEO_DMR_T3_STEP_HZ")
    if cc_freq_hz is None:
        cc_freq_hz = _env_freq_hz("DSD_NEO_DMR_T3_CC_FREQ")
    if cc_lcn is None:
        cc_lcn = _env_int("DSD_NEO_DMR_T3_CC_LCN")
    if start_lcn is None:
        start_lcn = _env_int("DSD_NEO_DMR_T3_START_LCN")
    if start_lcn is None or start_lcn <= 0:
        start_lcn = 1

    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            rows = [parse_frequency_hz(ln) for ln in f]
    except OSError as e:
        print(f"LCN calc: unable to open '{path}': {e}", file=sys.stderr)
        return 1

    freqs = sorted({hz for hz in rows if hz is not None})
    if not freqs:
        print(f"LCN calc: no frequencies parsed from '{path}'",
              file=sys.stderr)
        return 2

    if len(freqs) == 1:
        print("lcn,freq", file=out)
        print(f"{start_lcn},{freqs[0]}", file=out)
        return 0

    step = step_hz if step_hz and step_hz > 0 else infer_step_125(freqs)
    if step <= 0:
        print("LCN calc: could not infer channel step. "
              "Provide --calc-step / DSD_NEO_DMR_T3_STEP_HZ.",
              file=sys.stderr)
        return 3

    base_freq = freqs[0]
    base_lcn = start_lcn
    if cc_freq_hz and cc_lcn and cc_freq_hz > 0 and cc_lcn > 0:
        base_lcn = cc_lcn - round((cc_freq_hz - base_freq) / step)

    print("lcn,freq", file=out)
    for f_hz in freqs:
        lcn = base_lcn + round((f_hz - base_freq) / step)
        print(f"{lcn},{f_hz}", file=out)
    return 0
