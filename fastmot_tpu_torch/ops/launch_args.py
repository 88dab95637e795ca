"""What the hand kernels' wrappers share to call their C entries with little
host time: one allocation cut into typed views (``carve``), and ctypes
arrays of ints and floats made once for each tuple of values (``c_ints``,
``c_floats``), which the C entries only read."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

ALIGN = 16          # each part's address, in bytes


@functools.lru_cache(maxsize=256)
def c_ints(*values):
    """A ctypes int array of ``values``, made once for each tuple."""
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=256)
def c_floats(*values):
    """A ctypes float array of ``values``, made once for each tuple."""
    return (ctypes.c_float * len(values))(*values)


@functools.lru_cache(maxsize=256)
def _plan(parts):
    """``carve``'s layout of ``parts``: (float32 words, each part's (byte
    offset, dtype, shape, strides, element offset))."""
    plan, at = [], 0
    for part in parts:
        if isinstance(part, int):
            plan.append((at, None, None, None, None))
            size = part
        else:
            dtype, shape = part
            strides, step = [], 1
            for n in reversed(shape):
                strides.append(step)
                step *= n
            plan.append((at, dtype, tuple(shape), tuple(strides[::-1]),
                         at // dtype.itemsize))
            size = math.prod(shape) * dtype.itemsize
        at += (size + ALIGN - 1) // ALIGN * ALIGN
    return max(at, ALIGN) // 4, tuple(plan)


def carve(device, parts):
    """One allocation on ``device`` for ``parts`` (a tuple of (dtype, shape)
    or counts of bytes for scratch), each at a 16-byte boundary: (a
    contiguous view of each (dtype, shape) part and None for a count of
    bytes, each part's address, the allocation as float32 words)."""
    words, plan = _plan(parts)
    buf = torch.empty(words, dtype=torch.float32, device=device)
    base = buf.data_ptr()
    typed = {torch.float32: buf}
    views = []
    for _, dtype, shape, strides, at in plan:
        if dtype is None:
            views.append(None)
            continue
        view = typed.get(dtype)
        if view is None:
            view = typed[dtype] = buf.view(dtype)
        views.append(view.as_strided(shape, strides, at))
    return views, [base + x[0] for x in plan], buf
