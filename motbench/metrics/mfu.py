"""Model FLOPs of the profiled window over its length times 989 TFLOP/s
(H100 SXM, bf16 dense, the nets' conv dtype), in %: 2 x the
multiply-accumulates of every conv and linear layer of the detector for
each frame detected, plus OSNet's for each valid crop (padding rows are
not counted), from the configuration's shapes (``arith``)."""
from motbench import arith


def read(ctx):
    p = ctx.prof
    if p is None or p.trace is None:
        return None
    lo, hi = p.bounds
    flops = 2 * (p.info["n_assoc"] * ctx.streams * ctx.det_macs
                 + p.info["crops"] * ctx.osnet_macs)
    return flops / ((hi - lo) * arith.PEAK_BF16) * 100
