"""The program's tracer: named spans (``Profiler``) and counters (``count``).

Always on: each span's host time and self time (its length less what its
child spans cover) are summed by name on ``time.perf_counter``'s clock, and
each counter is summed by name. A span's parent is the span open on the
same thread when it opens.

After ``enable()``, each closed span is also kept in memory as a
``Record`` until ``records()`` hands it over: its id, name, parent's id,
step (the one it was given, the orchestrator's ``frame_count``, else its
parent's, else the last one given on the thread), kind, start, end and the
counts made while it was the innermost open span. While a
``torch.profiler`` records, each span then also opens a
``record_function('fastmot.<name>')`` range, which puts it on the clock of
the device's trace. Nothing is written to disk.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, namedtuple

Record = namedtuple('Record', 'id name parent step kind start end counts')

_local = threading.local()
_records = []
_ids = itertools.count()
_enabled = False


def _thread():
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.step = [], None
        return _local.stack


def enable():
    """Keep each span closed from now on for ``records()``."""
    global _enabled
    _enabled = True


def disable():
    """Keep no more spans (those kept stay for ``records()``)."""
    global _enabled
    _enabled = False


def records():
    """The spans closed while enabled since the last call, in the order
    they closed (a child before its parent); the list is cleared."""
    out = _records[:]
    del _records[:len(out)]
    return out


def count(name, n=1):
    """Adds ``n`` to the counter ``name`` and, while enabled, to the
    innermost open span's counts."""
    Profiler.counters[name] += n
    if _enabled:
        stack = _thread()
        if stack and stack[-1].id is not None:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def _profiling():
    import torch
    return torch.autograd._profiler_enabled()


class Profiler:
    """A span: ``with Profiler(name[, step, kind]): ...``; ``duration``
    (s) once closed. Work that only a record needs is done while enabled
    alone (``_open``, ``_close``)."""
    __slots__ = ('name', 'step', 'kind', 'start', 'duration', 'parent',
                 'child', 'id', 'counts', 'range', 'stack')

    timing = Counter()        # host s by name
    self_timing = Counter()   # host s by name, less the child spans'
    count = Counter()         # closed spans by name
    counters = Counter()      # ``count``'s sums by name

    def __init__(self, name, step=None, kind=None):
        self.name = name
        self.step = step
        self.kind = kind

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _thread()
        parent = stack[-1] if stack else None
        self.parent = parent
        self.child = 0.0
        self.stack = stack
        if self.step is not None:
            _local.step = self.step
        if _enabled:
            self._open(parent)
        else:
            self.id = None
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def _open(self, parent):
        if self.step is None:
            self.step = _local.step if parent is None else parent.step
        self.id = next(_ids)
        self.counts = {}
        self.range = None
        if _profiling():
            from torch.profiler import record_function
            self.range = record_function(f'fastmot.{self.name}')
            self.range.__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        end = time.perf_counter()
        elapsed = self.duration = end - self.start
        self.stack.pop()
        name, parent = self.name, self.parent
        Profiler.timing[name] += elapsed
        Profiler.self_timing[name] += elapsed - self.child
        Profiler.count[name] += 1
        if parent is not None:
            parent.child += elapsed
        if self.id is not None:
            self._close(parent, end)
        return False

    def _close(self, parent, end):
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _records.append(Record(
            self.id, self.name, None if parent is None else parent.id,
            self.step, self.kind, self.start, end, self.counts))

    @classmethod
    def reset(cls):
        cls.timing.clear()
        cls.self_timing.clear()
        cls.count.clear()
        cls.counters.clear()

    @classmethod
    def get_avg_millis(cls, name):
        n = cls.count[name]
        if n == 0:
            return 0.0
        return cls.timing[name] * 1000.0 / n

    @classmethod
    def get_avg_self_millis(cls, name):
        """The mean self time of the spans named ``name``, in ms."""
        n = cls.count[name]
        if n == 0:
            return 0.0
        return cls.self_timing[name] * 1000.0 / n
