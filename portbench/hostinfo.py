"""What the host and the card did during a run's window, read only:
this process's CPU seconds (``getrusage``) and, after the window, the
card's clocks, power, temperature and throttle reasons
(``nvidia-smi``).  They are printed beside the result, so that a run
that reads far off can be matched to its host: where the host sets the
pace, a slow run spends more CPU seconds on each block."""

from __future__ import annotations

import resource
import subprocess
import time

QUERY = ("clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu,"
         "clocks_throttle_reasons.active")
KEYS = ("sm_mhz", "mem_mhz", "power_w", "power_limit_w", "temp_c",
        "throttle")


def snapshot() -> tuple[float, float]:
    """(wall, CPU seconds of this process) now."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime + ru.ru_stime


def window(before, after, n_blocks: int) -> dict:
    """This process's CPU seconds a wall second and a block between two
    snapshots."""
    wall, cpu = after[0] - before[0], after[1] - before[1]
    return {"cpu_per_s": cpu / wall,
            "cpu_s_per_block": cpu / n_blocks if n_blocks else None}


def card(index: int = 0) -> dict | None:
    """The card's clocks (MHz), power (W), temperature (C) and active
    throttle reasons now, or None where ``nvidia-smi`` gives nothing."""
    try:
        p = subprocess.run(
            ["nvidia-smi", f"--id={index}", f"--query-gpu={QUERY}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    v = [x.strip() for x in p.stdout.strip().split(",")]
    if p.returncode != 0 or len(v) != len(KEYS):
        return None
    out = {}
    for k, x in zip(KEYS, v):
        try:
            out[k] = x if k == "throttle" else float(x)
        except ValueError:
            out[k] = x
    return out
