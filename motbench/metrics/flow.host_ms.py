"""Host time of ``StreamTracker.track`` per gap frame of the traced
window."""


def read(ctx):
    n = len(ctx.window["steps"].get("gap", []))
    s = ctx.host_spans.get(("flow", "gap"))
    return s / n * 1e3 if n and s is not None else None
