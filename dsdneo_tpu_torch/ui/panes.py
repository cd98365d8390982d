"""Channel-grid rows from decode contexts.

The port's copy of ``channels_from_contexts`` of
``dsdneo_tpu/ui/panes.py``, which ``engine.fleet.FleetMonitor.
channel_dicts`` renders its control groups with.  The rest of the
terminal UI waits for the CLI slice.
"""

from __future__ import annotations


def channels_from_contexts(ctxs, freqs=None) -> list[dict]:
    """Per-channel ``DecoderContext``s (the batched CC pipelines'
    ``ctxs``) → channel-grid dicts.  A channel shows 'voice' while its
    last events carry an active talkgroup, 'cc' when control traffic is
    flowing, else 'idle'."""
    out = []
    for i, ctx in enumerate(ctxs):
        st = "idle"
        tg = getattr(ctx.state, "last_tg", 0) or 0
        if ctx.events:
            tail = ctx.events[-8:]
            if any("VOICE" in e.line or "4V" in e.line for e in tail):
                st = "voice"
            elif any(("TSBK" in e.line) or ("CSBK" in e.line)
                     or ("TSDU" in e.line) for e in tail):
                st = "cc"
        out.append({"id": i, "state": st, "tg": tg if st == "voice" else 0,
                    "freq_hz": (freqs[i] if freqs is not None else 0.0)})
    return out
