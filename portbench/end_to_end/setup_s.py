"""``setup_s``: process start to the first timed block (imports, the
port's library load or build, the inputs, the pipeline, the warm-up)."""


def read(ctx):
    return ctx.setup_s
