"""Host frames onto the device: the orchestrators' one staging path.

Host input (an ndarray, a read-only memory map, a list of arrays, a CPU
tensor) is copied into the next slot of a small ring of reused host
buffers, page-locked where the target is a card, by torch's own copy (on
its intra-op threads). The device tensor is a fresh allocation filled from
the slot by a non-blocking copy on the current stream, so that the copy
stays ordered before the kernels that read it, and an event recorded after
the copy guards the slot: the host waits on it only if the ring comes back
to the slot before that copy is done. The caller may overwrite its array as
soon as the call returns, and keep the tensor for as long as it likes.
Frames already on a card are stacked or copied there, with no host copy.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from . import profiler
from .profiler import Profiler

SLOTS = 3


def _host_tensor(frame) -> torch.Tensor:
    """A CPU tensor viewing ``frame``; a read-only array is viewed too,
    since it is only read."""
    if isinstance(frame, torch.Tensor):
        return frame
    frame = np.asarray(frame)
    if frame.flags.writeable:
        return torch.from_numpy(frame)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)
        return torch.from_numpy(frame)


class FrameStager:
    """``stager(frames) -> tensor`` on ``device``: an [H, W, 3] frame, an
    [S, H, W, 3] batch or a list of S frames ([S, H, W, 3] out). Counts
    ``stage_pinned`` for each batch staged through a page-locked slot, and
    ``stage_slot_waits`` and ``host_syncs`` for each wait on a slot."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._key = None
        self._slots, self._events = [], []
        self._next = 0

    def __call__(self, frames) -> torch.Tensor:
        with Profiler('stage'):
            if isinstance(frames, (list, tuple)):
                if all(isinstance(f, torch.Tensor) and f.device.type != 'cpu'
                       for f in frames):
                    return torch.stack(frames).to(self.device)
                rows = [_host_tensor(f) for f in frames]
                first = rows[0]
                if any(r.shape != first.shape or r.dtype != first.dtype
                       for r in rows):
                    raise ValueError('frames of one batch differ in shape '
                                     'or dtype')
                shape, dtype = (len(rows),) + tuple(first.shape), first.dtype
            elif isinstance(frames, torch.Tensor) and \
                    frames.device.type != 'cpu':
                return frames.to(self.device, copy=True)
            else:
                rows = _host_tensor(frames)
                shape, dtype = tuple(rows.shape), rows.dtype
            slot, event = self._slot(shape, dtype)
            if isinstance(rows, list):
                for dst, row in zip(slot, rows):
                    dst.copy_(row)
            else:
                slot.copy_(rows)
            out = slot.to(self.device, non_blocking=True, copy=True)
            if event is not None:
                event.record(torch.cuda.current_stream(self.device))
                profiler.count('stage_pinned')
            return out

    def _slot(self, shape, dtype):
        """The next slot and its event (None unless pinned), once the copy
        last made from it is done; the ring is allocated anew for a new
        shape or dtype."""
        if self._key != (shape, dtype):
            pin = self.device.type == 'cuda'
            self._slots = [torch.empty(shape, dtype=dtype, pin_memory=pin)
                           for _ in range(SLOTS)]
            self._events = [torch.cuda.Event() if pin else None
                            for _ in range(SLOTS)]
            self._key, self._next = (shape, dtype), 0
        i = self._next
        self._next = (i + 1) % SLOTS
        event = self._events[i]
        if event is not None and not event.query():
            profiler.count('stage_slot_waits')
            profiler.count('host_syncs')
            event.synchronize()
        return self._slots[i], event
