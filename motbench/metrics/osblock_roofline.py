"""The OSBlock kernel's share of its roofline: the least time an H100
could take for the profiled cycles' OSBlock calls (``arith.
osblock_bound_ms`` at each call's shapes, S x 128 crops) over the
kernel's device time in the trace, in %."""
from motbench import arith


def read(ctx):
    p = ctx.prof
    if p is None or p.trace is None or not p.info["n_assoc"]:
        return None
    device_s = p.trace.device_s(fragment="osblock_kernel")
    if device_s <= 0:
        return None
    batch = ctx.streams * 128
    bound_ms = sum(arith.osblock_bound_ms(batch, h, w, cin, f)
                   for h, w, cin, f in ctx.osblock_shapes)
    return bound_ms * p.info["n_assoc"] / (device_s * 1e3) * 100
