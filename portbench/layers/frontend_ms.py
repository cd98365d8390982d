"""``frontend_ms``: host milliseconds a block of ``frontend_dispatch`` +
``frontend_finish`` (the block's copy to the card on per-channel cells,
K1, symbolize, sync, NID, the candidates to the host), synchronized,
over the split blocks."""


def read(ctx):
    v = ctx.split.get("frontend")
    return 1e3 * sum(v) / len(v) if v else None
