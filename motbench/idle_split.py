"""The device's idle time split by what the host was doing: the program's
own spans (the ``fastmot.*`` ranges that ``fastmot_tpu_torch.utils.
profiler`` opens while ``torch.profiler`` records and its tracer is
enabled) read from a Kineto Chrome trace, and every idle instant of the
profiled window charged to the innermost of them open on the host then.

The idle intervals are those ``device.idle_share`` reads: the gaps between
the kernels in the window (``arith.idle_gaps``), copies counted as idle. A
gap is split across the spans the host passed through while it lasted;
time outside every program span is charged to ``None``.
"""
from __future__ import annotations

from collections import defaultdict

from . import arith

PREFIX = 'fastmot.'


def program_spans(events):
    """(start s, end s, name) of each ``fastmot.*`` range of the trace's
    events, the prefix taken off."""
    return sorted(
        (e['ts'] * 1e-6, (e['ts'] + e['dur']) * 1e-6, e['name'][len(PREFIX):])
        for e in events
        if e.get('cat') == 'user_annotation'
        and e.get('name', '').startswith(PREFIX))


def innermost(spans):
    """The union of nested ``(start, end, name)`` spans (one host thread's)
    as pieces ``(a, b, name)``, each named by the innermost span open over
    it, in time order."""
    pieces, stack, t = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            pieces.append((t, end, top))
            t = end
        if stack:
            pieces.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a
    while stack:
        end, top = stack.pop()
        pieces.append((t, end, top))
        t = end
    return [p for p in pieces if p[1] > p[0]]


def charge_idle(kernels, spans, lo, hi):
    """``{span name or None: idle s}`` over ``[lo, hi]`` (s): each gap
    between the ``(start, end)`` kernel intervals, charged to the innermost
    span of ``spans`` open at each instant of it, weighted by time."""
    out = defaultdict(float)
    pieces = innermost(spans)
    i = 0
    for a, b in arith.idle_gaps(kernels, lo, hi):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        t, j = a, i
        while t < b and j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            if pa > t:
                out[None] += pa - t
                t = pa
            end = min(pb, b)
            out[name] += end - t
            t = end
            j += 1
        if t < b:
            out[None] += b - t
    return dict(out)


# the idle metrics' groups of spans; the rest (``reid``, ``assoc`` and
# ``step``'s own time) is the remainder
GROUPS = {
    'device.idle_detector': ('detector', 'detector.post'),
    'device.idle_flow': ('flow',),
    'device.idle_stage': ('stage',),
    'device.idle_sync': ('sync', 'sync.fetch', 'sync.replay'),
    'device.idle_outside_program': (None,),
}


def split(charged, lo, hi):
    """Each group's share of the window ``[lo, hi]`` in %, and the
    remainder's under ``'remainder'``."""
    out = {k: sum(charged.get(n, 0.0) for n in names) / (hi - lo) * 100
           for k, names in GROUPS.items()}
    grouped = {n for names in GROUPS.values() for n in names}
    out['remainder'] = sum(v for n, v in charged.items()
                           if n not in grouped) / (hi - lo) * 100
    return out
