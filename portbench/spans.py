"""The program's own spans and counters over the profiled span, as its
tracer kept them (``dsdneo_tpu_torch.runtime.trace.last_session()``),
for the per-layer metrics that read them.  Each figure is a total over
the session divided by the session's own count of blocks, the counter
that the caller names (``blocks``: the P25 pipeline's is
``p25.blocks``); None from a program without the tracer or a session
that took no block."""


def _session(blocks: str):
    try:
        from dsdneo_tpu_torch.runtime import trace
    except ImportError:
        return None
    s = trace.last_session()
    return s if s.total(blocks) > 0 else None


def ms_a_block(*names: str, blocks: str):
    """Milliseconds a block in the spans ``names``, the blocks counted
    by the counter ``blocks``."""
    s = _session(blocks)
    if s is None:
        return None
    return sum(s.ms(n) for n in names) / s.total(blocks)


def pct(part: str, whole: str, blocks: str):
    """100 × the counter ``part`` over the counter ``whole``, in a
    session that counted blocks on the counter ``blocks``."""
    s = _session(blocks)
    if s is None or s.total(whole) <= 0:
        return None
    return 100.0 * s.total(part) / s.total(whole)
