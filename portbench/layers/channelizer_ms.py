"""``channelizer_ms``: the channelizer's device milliseconds a block
(``engine.wideband.channelize_band_device``, the band's copy to the card
included), CUDA events around the call over the split blocks."""


def read(ctx):
    v = ctx.split.get("channelizer")
    return 1e3 * sum(v) / len(v) if v else None
