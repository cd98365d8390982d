"""The program's own spans and counters over the profiled span, as its
tracer kept them (``dsdneo_tpu_torch.runtime.trace.last_session()``),
for the per-layer metrics that read them.  Each figure is a total over
the session divided by the session's own count of blocks
(``p25.blocks``); None from a program without the tracer or a session
that took no block."""


def _session():
    try:
        from dsdneo_tpu_torch.runtime import trace
    except ImportError:
        return None
    s = trace.last_session()
    return s if s.total("p25.blocks") > 0 else None


def ms_a_block(*names: str):
    """Milliseconds a block in the spans ``names``."""
    s = _session()
    if s is None:
        return None
    return sum(s.ms(n) for n in names) / s.total("p25.blocks")


def pct(part: str, whole: str):
    """100 × the counter ``part`` over the counter ``whole``."""
    s = _session()
    if s is None or s.total(whole) <= 0:
        return None
    return 100.0 * s.total(part) / s.total(whole)
