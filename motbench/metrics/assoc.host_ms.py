"""Host time of ``StreamTracker.update_device`` per association frame of
the traced window."""


def read(ctx):
    n = len(ctx.window["steps"].get("assoc", []))
    s = ctx.host_spans.get(("assoc", "assoc"))
    return s / n * 1e3 if n and s is not None else None
