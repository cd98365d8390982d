"""Reading the profiler's trace of a span of whole blocks.

The span runs under ``torch.profiler`` with the CPU and CUDA activities;
the entry's own ranges (``record_function`` around its calls into the
port, named by the entry through ``rec.span``) are CPU events of the
same trace.  From the raw events this module takes the union of device
activity (kernels and copies), each device operation's time and
launches by name, and the idle gaps of the device labelled by the
entry's range the host was in.
"""

from __future__ import annotations

from dataclasses import dataclass, field

@dataclass
class Span:
    """What a profiled span of ``n_blocks`` whole blocks held."""
    n_blocks: int
    wall_s: float
    busy_s: float = 0.0
    device_ops: dict = field(default_factory=dict)    # name → seconds
    launches: dict = field(default_factory=dict)      # name → count
    idle_by_host: dict = field(default_factory=dict)  # range → seconds

    def kernel(self, part: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``part``."""
        hit = [n for n in self.device_ops if part in n]
        return (sum(self.device_ops[n] for n in hit),
                sum(self.launches[n] for n in hit))


def _t(e, what: str) -> float:
    """An event's start or duration in seconds, whichever unit the
    profiler build reports."""
    if hasattr(e, f"{what}_ns"):
        return getattr(e, f"{what}_ns")() * 1e-9
    return getattr(e, f"{what}_us")() * 1e-6


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type()) or "GPU" in str(e.device_type())


def summarize(prof, n_blocks: int, wall_s: float, ranges=()) -> Span:
    """The span's device activity from ``prof`` (a finished
    ``torch.profiler.profile``); ``ranges`` are the names of the entry's
    own ranges."""
    ranges = set(ranges)
    span = Span(n_blocks=n_blocks, wall_s=wall_s)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _t(e, "start"), _t(e, "duration")
        if _is_device(e):
            # the entry's ranges appear on the device's timeline too
            # (user annotations); they are not device work
            if dur <= 0 or name in ranges:
                continue
            dev.append((start, start + dur))
            span.device_ops[name] = span.device_ops.get(name, 0.0) + dur
            span.launches[name] = span.launches.get(name, 0) + 1
        elif name in ranges:
            host.append((start, start + dur, name))
    if not dev:
        return span
    dev.sort()
    merged = [list(dev[0])]
    for a, b in dev[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    span.busy_s = sum(b - a for a, b in merged)
    host.sort()
    for (a0, b0), (a1, _b1) in zip(merged, merged[1:]):
        gap = a1 - b0
        mid = 0.5 * (b0 + a1)
        inner = [(b - a, n) for a, b, n in host if a <= mid <= b]
        label = min(inner)[1] if inner else "host outside the entry's calls"
        span.idle_by_host[label] = span.idle_by_host.get(label, 0.0) + gap
    return span


def breakdown(span: Span) -> dict:
    """The contract's ``breakdown``: the ten device operations that took
    most time, and the idle gaps summed by what the host was doing, each
    [name, seconds] over the span."""
    top = sorted(span.device_ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(span.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
