"""The pre-LK point assembly of a gap frame in hand-written kernels: the
depth order of the tracks, corner management and the LK point set, for
every stream of a call.

``gap_points`` is the entry the tracker's gap frames call. On CUDA tensors
it calls ``csrc/gap_points.cu`` (built at first use: two launches, the
candidates' owners, then, a programmatic dependent launch beside them, a
block a track slot and one a stream for the background; no host sync); on
CPU tensors it runs the plain version,
``gap_points_reference`` (``tracker.gap_points_core`` for one stream,
``tracker.gap_points_batch`` for several); any other device raises. The
two agree bit for bit (tests/test_torch_gap_points.py).
``gap_points.launches`` counts the kernel's calls.
"""
from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import flow_kernels as fk

KERNEL_MAX_TRACKS = 255      # kMaxTracks in csrc/gap_points.cu
OWNER_CHUNK = 256            # kOwnerChunk: the candidates an owner block tests
N_STATE = 15                 # tracker.N_STATE, which asserts they agree
# the state fields the kernel reads (N_STATE indices): boxes, validity,
# ages, keypoints and their validity
STATE_IN = (2, 3, 4, 11, 12)

# gap_points_forward's C signature
FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]


@functools.cache
def gap_points_library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from .cuda_build import load
    lib = load('gap_points')
    lib.gap_points_forward.argtypes = FORWARD_ARGTYPES
    lib.gap_points_forward.restype = ctypes.c_int
    lib.gap_points_error_string.argtypes = [ctypes.c_int]
    lib.gap_points_error_string.restype = ctypes.c_char_p
    return lib


def _fault(msg):
    raise ValueError(f'gap_points: {msg}')


class _Layout(NamedTuple):
    """What one kind of call (sizes, device, constants) needs, made once:
    the inputs' expected (dtype, shape, device, contiguous), the entry's
    int and float arrays, the sizes of the float32, bool and int64
    buffers, and the outputs (all_prev, all_valid, inside, forder,
    f_tlbrs, f_valid, then the scratch: each candidate's and bg
    candidate's owning track, a byte each) as (buffer, shape,
    strides, element offset); buffers 0 float32, 1 bool, 2 int64."""
    signature: list
    ints: ctypes.Array
    floats: ctypes.Array
    sizes: tuple
    outputs: tuple


_PTRS = ctypes.c_uint64 * 16            # the Ptr enum's pointers
_DTYPES = (torch.float32, torch.bool, torch.int64)
_ITEM = (4, 1, 8)


def _expected(lead, n_tracks, n_cands, n_bg):
    """(name, dtype, shape) of each input, in the Ptr enum's order."""
    k = fk.KP_PER_TRACK
    return (('tlbrs', torch.float32, lead + (n_tracks, 4)),
            ('valid', torch.bool, lead + (n_tracks,)),
            ('ages', torch.int32, lead + (n_tracks,)),
            ('kps', torch.float32, lead + (n_tracks, k, 2)),
            ('kp_valid', torch.bool, lead + (n_tracks, k)),
            ('cand_pts', torch.float32, lead + (n_cands, 2)),
            ('cand_score', torch.float32, lead + (n_cands,)),
            ('bg_pts', torch.float32, lead + (n_bg, 2)),
            ('bg_score', torch.float32, lead + (n_bg,)))


@functools.cache
def _layout(key, device):
    """The _Layout of a call; raises ValueError on sizes the kernel does
    not take."""
    (n_streams, stream_axis, n_tracks, f_cap, n_cands, n_bg, size,
     quality, density) = key
    lead = (n_streams,) if stream_axis else ()
    cols, rows = size[0] // fk.CELL, size[1] // fk.CELL
    if not 1 <= n_streams <= 65535:
        _fault(f'{n_streams} streams: the kernel takes 1 to 65535')
    if not 1 <= n_tracks <= KERNEL_MAX_TRACKS:
        _fault(f'{n_tracks} track slots: the kernel takes 1 to '
               f'{KERNEL_MAX_TRACKS}')
    if not 1 <= f_cap <= min(fk.MAX_FLOW_TRACKS, n_tracks):
        _fault(f'flow budget {f_cap}: the kernel takes 1 to '
               f'{min(fk.MAX_FLOW_TRACKS, n_tracks)}')
    if n_cands != rows * cols or n_cands < fk.KP_PER_TRACK:
        _fault(f'{n_cands} candidates: a {size[0]}x{size[1]} frame has '
               f'{rows * cols} cells of {fk.CELL} px, and the kernel takes '
               f'at least {fk.KP_PER_TRACK}')
    if n_bg < 1:
        _fault('no background candidates')
    keep = min(fk.BG_KP, n_bg)
    n_points = f_cap * fk.KP_PER_TRACK + keep
    sizes, outputs = [0, 0, 0], []
    for buf, shape in ((0, (n_points, 2)), (1, (n_points,)), (0, (f_cap, 4)),
                       (2, (f_cap,)), (0, (f_cap, 4)), (1, (f_cap,)),
                       (1, (n_cands + n_bg,))):
        shape = lead + shape
        strides = tuple(math.prod(shape[j + 1:]) for j in range(len(shape)))
        outputs.append((buf, shape, strides, sizes[buf]))
        n = n_streams * math.prod(shape[len(lead):])
        sizes[buf] += -(-n // 16) * 16
    ints = (n_streams, n_tracks, f_cap, n_cands, cols, n_bg, keep, *size)
    return _Layout(
        [(dtype, torch.Size(shape), device, True) for _, dtype, shape in
         _expected(lead, n_tracks, n_cands, n_bg)],
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_float * 2)(quality, density), tuple(sizes), tuple(outputs))


def _inputs(states, prev_states):
    if len(states) != N_STATE:
        _fault(f'{len(states)} state fields, expected {N_STATE}')
    if len(prev_states) != 6:
        _fault(f'{len(prev_states)} flow state fields, expected 6')
    return tuple(states[i] for i in STATE_IN) + tuple(prev_states[2:])


def gap_points_launch_args(spec: fk.FlowSpec, states, prev_states,
                           f_cap: int):
    """One kernel call as ``gap_points_forward`` takes it: ``(outputs,
    args)``, the outputs (all_prev, all_valid, inside, forder, f_tlbrs,
    f_valid) and the entry's argument tuple writing them and the kernel's
    scratch (on the current CUDA stream for CUDA tensors). The tensors
    carry a leading stream axis [S, ...] or none (one stream), and the
    outputs follow them. Raises ValueError on a wrong dtype, shape or
    device, a tensor that is not contiguous, or sizes the kernel does not
    take. The arguments hold the tensors' addresses, so they serve as long
    as the outputs and the inputs live. The outputs are views of a float32,
    a bool and an int64 buffer; the common case checks the inputs with one
    comparison of their (dtype, shape, device, contiguous) against those of
    a call of the same sizes, made once."""
    inputs = _inputs(states, prev_states)
    tlbrs = inputs[0]
    if tlbrs.dim() not in (2, 3) or tlbrs.shape[-1] != 4:
        _fault(f'tlbrs {tuple(tlbrs.shape)}: expected [S, T, 4] or [T, 4]')
    stream_axis = tlbrs.dim() == 3
    n_streams = tlbrs.shape[0] if stream_axis else 1
    n_tracks = tlbrs.shape[-2]
    n_cands = inputs[6].shape[-1] if inputs[6].dim() else -1
    n_bg = inputs[8].shape[-1] if inputs[8].dim() else -1
    device = tlbrs.device
    key = (int(n_streams), stream_axis, int(n_tracks), int(f_cap),
           int(n_cands), int(n_bg), tuple(spec.size),
           float(spec.quality_level), float(spec.feat_density))
    layout = _layout(key, device)
    try:
        ok = [(t.dtype, t.shape, t.device, t.is_contiguous())
              for t in inputs] == layout.signature
    except AttributeError:         # not a tensor
        ok = False
    if not ok:
        lead = (n_streams,) if stream_axis else ()
        for t, (name, dtype, shape) in zip(
                inputs, _expected(lead, n_tracks, n_cands, n_bg)):
            if not isinstance(t, torch.Tensor):
                _fault(f'{name} is not a tensor')
            if t.dtype != dtype:
                _fault(f'{name} is {t.dtype}, expected {dtype}')
            if tuple(t.shape) != tuple(shape):
                _fault(f'{name} is {tuple(t.shape)}, expected '
                       f'{tuple(shape)}')
            if t.device != device:
                _fault(f'{name} is on {t.device}, tlbrs on {device}')
            if not t.is_contiguous():
                _fault(f'{name} is not contiguous')
    bufs = [torch.empty(n, dtype=dtype, device=device)
            for n, dtype in zip(layout.sizes, _DTYPES)]
    base = [b.data_ptr() for b in bufs]
    outputs = tuple(bufs[b].as_strided(shape, strides, offset)
                    for b, shape, strides, offset in layout.outputs[:-1])
    ptrs = [t.data_ptr() for t in inputs] + [
        base[b] + _ITEM[b] * offset for b, _, _, offset in layout.outputs]
    stream = torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None
    args = (_PTRS.from_buffer(array.array('Q', ptrs)), layout.ints,
            layout.floats, stream)
    return outputs, args


def gap_points_reference(spec: fk.FlowSpec, states, prev_states,
                         f_cap: int):
    """The plain version of ``gap_points``: ``tracker.gap_points_core``
    without a stream axis, ``tracker.gap_points_batch`` (its outputs made
    contiguous) with one."""
    from .. import tracker
    if states[2].dim() == 2:
        return tracker.gap_points_core(spec, states, prev_states, f_cap)
    return tuple(t.contiguous() for t in tracker.gap_points_batch(
        spec, f_cap, states, prev_states))


def gap_points(spec: fk.FlowSpec, states, prev_states, f_cap: int):
    """Depth sort (near first), corner management and LK point assembly
    over the first ``f_cap`` active tracks of each stream:
    ``tracker.gap_points_core``'s arguments, with a leading stream axis
    [S, ...] on the state and the flow state or without one. Returns
    (all_prev, all_valid, inside, forder, f_tlbrs, f_valid), with the
    inputs' stream axis. On CUDA tensors one call of
    ``csrc/gap_points.cu``'s ``gap_points_forward``
    (``gap_points_launch_args``' checks apply); on CPU tensors
    ``gap_points_reference``; any other device raises."""
    device = states[2].device
    if device.type == 'cpu':
        return gap_points_reference(spec, states, prev_states, f_cap)
    if device.type != 'cuda':
        raise ValueError(f'gap_points: unsupported device {device}')
    outputs, args = gap_points_launch_args(spec, states, prev_states, f_cap)
    lib = gap_points_library()
    code = lib.gap_points_forward(*args)
    if code:
        raise RuntimeError('gap_points kernel: '
                           + lib.gap_points_error_string(code).decode())
    gap_points.launches += 1
    return outputs


gap_points.launches = 0
