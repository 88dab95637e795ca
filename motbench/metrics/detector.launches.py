"""Kernel launches inside the benchmark's detector span, per association
frame of the profiled cycles."""


def read(ctx):
    p = ctx.prof
    if p is None or p.trace is None or not p.info["n_assoc"]:
        return None
    return p.trace.launches("detector") / p.info["n_assoc"]
