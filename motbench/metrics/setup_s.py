"""Process start to the first timed frame: imports, the CUDA context, the
kernels' build or load, weights, traffic and the warm-up cycles."""


def read(ctx):
    return ctx.setup_s
