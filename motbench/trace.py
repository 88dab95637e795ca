"""The traced window: ``torch.profiler`` over a few skip cycles, read from
its Chrome trace.

Each kernel is tied to the benchmark span it was launched in through its
launch's correlation id (the CUDA runtime or driver call on the host,
inside the span's ``record_function`` range). The profiler has been seen
to return traces with fewer device events than were launched, so a trace
is checked against the program's own launch counters and taken again, a
bounded number of times, when they disagree.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter

import torch

from . import arith

# (program counter, kernel-name fragment): a trace is complete when it
# holds as many kernels of the name as the counter counted launches
COUNTED = (
    ('ops.osnet_block', 'osblock', 'osblock_kernel'),
    ('ops.reid_crops', 'reid_crops', 'reid_crops_kernel'),
    ('ops.flow_kernels', 'preprocess', 'preprocess_kernel'),
)


def launch_counts() -> dict:
    """The program's launch counters that ``COUNTED`` names, now."""
    import importlib
    out = {}
    for mod, fn, kernel in COUNTED:
        m = importlib.import_module(f'fastmot_tpu_torch.{mod}')
        out[kernel] = int(getattr(getattr(m, fn), 'launches', 0))
    return out


class Trace:
    """Kernels (name, start, end in s, span) and host spans of a profiled
    window, from a Kineto Chrome trace."""

    def __init__(self, events):
        spans, launches, kernels = [], {}, []
        for e in events:
            cat = e.get('cat', '')
            if cat == 'user_annotation' and \
                    e.get('name', '').startswith('motbench.'):
                spans.append((e['ts'], e['ts'] + e['dur'],
                              e['name'][len('motbench.'):]))
            elif cat in ('cuda_runtime', 'cuda_driver'):
                corr = e.get('args', {}).get('correlation')
                if corr is not None:
                    launches[corr] = e['ts']
            elif cat == 'kernel':
                kernels.append(e)
        spans.sort()
        self.spans = spans
        starts = [s[0] for s in spans]
        self.kernels = []
        tied = 0
        for e in kernels:
            t = launches.get(e.get('args', {}).get('correlation'))
            span = None
            if t is not None:
                tied += 1
                span = _innermost(spans, starts, t)
            self.kernels.append((e['name'], e['ts'] * 1e-6,
                                 (e['ts'] + e['dur']) * 1e-6, span))
        self.tied = tied

    def count(self, fragment: str) -> int:
        return sum(1 for k in self.kernels if fragment in k[0])

    def device_s(self, span=None, fragment=None) -> float:
        return sum(b - a for name, a, b, s in self.kernels
                   if (span is None or s == span)
                   and (fragment is None or fragment in name))

    def launches(self, span) -> int:
        return sum(1 for k in self.kernels if k[3] == span)

    def busy_s(self) -> float:
        return arith.busy_seconds((a, b) for _, a, b, _ in self.kernels)

    def breakdown(self, lo: float, hi: float):
        """The ten device operations that took most time, and the ten
        longest idle gaps in [lo, hi] (s), each named by the benchmark
        span the host was in when it began."""
        by_name = Counter()
        for name, a, b, _ in self.kernels:
            by_name[name] += b - a
        ops = [[n, s] for n, s in by_name.most_common(10)]
        starts = [s[0] for s in self.spans]
        gaps = arith.idle_gaps([(a, b) for _, a, b, _ in self.kernels],
                               lo, hi)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            span = _innermost(self.spans, starts, a * 1e6)
            named.append([span or 'outside_spans', b - a])
        return {'device_ops': ops, 'idle_gaps': named}


def _innermost(spans, starts, t):
    """The name of the latest-starting span that contains host time
    ``t`` (us)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for a, b, name in reversed(spans[max(0, i - 64):i]):
        if a <= t <= b:
            best = name
            break
    return best


def profiled(run, tries=3):
    """Runs ``run()`` under the profiler until the trace holds every
    counted launch (at most ``tries`` times). Returns (Trace, run's
    result, the window's device-clock bounds in s, whether the last
    trace was complete, the counters' deltas)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(tries):
        before = launch_counts()
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            with torch.profiler.record_function('motbench.window'):
                info = run()
                torch.cuda.synchronize()
        after = launch_counts()
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.unlink(path)
        window = [e for e in events if e.get('name') == 'motbench.window'
                  and e.get('cat') == 'user_annotation']
        events = [e for e in events if e.get('name') != 'motbench.window']
        tr = Trace(events)
        deltas = {k: after[k] - before[k] for k in after}
        complete = all(tr.count(k) == v for k, v in deltas.items()) and \
            tr.tied == len(tr.kernels) and bool(window)
        if complete:
            break
    lo = window[0]['ts'] * 1e-6 if window else 0.0
    hi = (window[0]['ts'] + window[0]['dur']) * 1e-6 if window else 0.0
    return tr, info, (lo, hi), complete, deltas

