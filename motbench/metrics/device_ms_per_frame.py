"""Device time a frame costs: the union of the kernels' device intervals
over the profiled cycles after the window (every stream's frames of
``measure.TRACE_CYCLES`` skip cycles), over the frames they step, in ms.
Copies are not kernels and are not counted."""


def read(ctx):
    p = ctx.prof
    if p is None or p.trace is None:
        return None
    frames = (p.info["n_assoc"] + p.info["n_gap"]) * ctx.streams
    return p.trace.busy_s() / frames * 1e3 if frames else None
