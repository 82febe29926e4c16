"""setup_s (s, lower): from the process's start to the first timed call:
imports, the card, the CUDA library in the port's ``_build/`` (built on a
checkout's first run), the traffic pool, the weights, the pipeline and
the warm-up."""


def read(ctx):
    return ctx.setup_s
