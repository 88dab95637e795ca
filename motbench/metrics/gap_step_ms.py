"""Synchronised time of the gap-frame steps of the traced window: all of
their time over their count."""
from motbench.measure import mean_ms


def read(ctx):
    return mean_ms(ctx.window["steps"].get("gap", []))
