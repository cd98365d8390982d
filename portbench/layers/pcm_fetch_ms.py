"""``pcm_fetch_ms``: host milliseconds a block of ``fetch_pcm`` (the wire
to the host and the ADPCM expand), over the split blocks."""


def read(ctx):
    v = ctx.split.get("pcm_fetch")
    return 1e3 * sum(v) / len(v) if v else None
