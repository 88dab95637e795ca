"""Device time of the kernels launched inside the benchmark's detector span
(``detect_async`` and ``postprocess_device_batch``), per association frame
of the profiled cycles."""


def read(ctx):
    p = ctx.prof
    if p is None or p.trace is None or not p.info["n_assoc"]:
        return None
    return p.trace.device_s("detector") / p.info["n_assoc"] * 1e3
