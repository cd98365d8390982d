"""``pick_decode_ms``: host milliseconds a block of
``decode_from_frontend`` (the host LDU pick and the voice decode: IMBE
ECC, K2, synthesis, K3), synchronized, over the split blocks."""


def read(ctx):
    v = ctx.split.get("pick_decode")
    return 1e3 * sum(v) / len(v) if v else None
