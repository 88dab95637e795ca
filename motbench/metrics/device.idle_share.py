"""One minus the union of the kernels' device intervals over the
profiled window, in %."""


def read(ctx):
    p = ctx.prof
    if p is None or p.trace is None:
        return None
    lo, hi = p.bounds
    return (1.0 - p.trace.busy_s() / (hi - lo)) * 100
