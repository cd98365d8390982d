"""Real-time scheduling + CPU affinity (reference src/runtime/
rt_sched.cpp: SCHED_FIFO and per-thread affinity, env-gated).

``apply_rt_policy`` applies the env-configured policy to the calling
process/thread: ``DSD_NEO_RT_SCHED=1`` requests SCHED_FIFO at
``DSD_NEO_RT_PRIO`` (default 10), ``DSD_NEO_CPU_AFFINITY`` pins to a
comma-separated CPU list.  Like the reference, failures (no privilege,
unsupported platform) degrade gracefully — the decode threads never
require elevated scheduling to function.

The port's own copy of ``dsdneo_tpu/runtime/rt_sched.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import os


def parse_cpu_list(spec: str) -> set[int]:
    """"0,2-3" → {0, 2, 3} (the reference's affinity list syntax)."""
    cpus: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, _, b = part.partition("-")
            try:
                cpus.update(range(int(a), int(b) + 1))
            except ValueError:
                continue
        else:
            try:
                cpus.add(int(part))
            except ValueError:
                continue
    return cpus


def apply_rt_policy(environ: dict | None = None,
                    role: str | None = None) -> dict:
    """Apply the env-configured scheduling policy; returns a report
    dict {rt_requested, rt_applied, affinity_requested,
    affinity_applied, errors} (never raises).

    ``role`` selects the reference's per-thread knobs
    (rt_sched.cpp dsd_rt_sched_apply_for_role): ``"demod"`` /
    ``"dongle"`` / ``"usb"`` threads read
    ``DSD_NEO_RT_PRIO_<ROLE>`` and ``DSD_NEO_CPU_<ROLE>`` first,
    falling back to the process-wide ``DSD_NEO_RT_PRIO`` /
    ``DSD_NEO_CPU_AFFINITY``.  On Linux, pid 0 targets the calling
    thread, so per-role calls from each thread pin independently."""
    env = environ if environ is not None else os.environ
    report = {"rt_requested": False, "rt_applied": False,
              "affinity_requested": set(), "affinity_applied": False,
              "errors": []}
    suffix = role.upper() if role else ""
    if env.get("DSD_NEO_RT_SCHED", "") not in ("", "0", "false"):
        report["rt_requested"] = True
        prio = 10
        try:
            prio = int(env.get(f"DSD_NEO_RT_PRIO_{suffix}", "") or
                       env.get("DSD_NEO_RT_PRIO", "10"))
        except ValueError:
            pass
        try:
            os.sched_setscheduler(0, os.SCHED_FIFO,
                                  os.sched_param(prio))
            report["rt_applied"] = True
        except (AttributeError, OSError, PermissionError) as e:
            report["errors"].append(f"SCHED_FIFO: {e}")
    spec = (env.get(f"DSD_NEO_CPU_{suffix}", "") if suffix else "") \
        or env.get("DSD_NEO_CPU_AFFINITY", "")
    if spec:
        cpus = parse_cpu_list(spec)
        report["affinity_requested"] = cpus
        if cpus:
            try:
                os.sched_setaffinity(0, cpus)
                report["affinity_applied"] = True
            except (AttributeError, OSError) as e:
                report["errors"].append(f"affinity: {e}")
    return report
