"""The association frame's commit in a hand-written kernel: the lifecycle
decisions, the slot and history allocation and the state commit of
``tracker.commit_part`` for every stream of a call.

``assoc_commit`` is the entry the tracker's association frames call
(``tracker.commit_core`` and ``tracker.commit_batch``). On CUDA tensors it
calls ``csrc/assoc_commit.cu`` (built at first use: the decisions a block
a stream, then the wide rows a warp a row behind them by a programmatic
dependent launch; no host sync); on CPU tensors it runs the plain
version, ``commit_reference`` (``tracker.commit_part``, under
``torch.func.vmap`` over the streams); any other device raises. The two give the same
integers, booleans and feature sums bit for bit, and means and covariances
within float32 rounding (tests/test_torch_assoc_commit.py).
``assoc_commit.launches`` counts the kernel's calls (a call's two
launches count once).
"""
from __future__ import annotations

import array
import ctypes
import functools
import operator
from typing import NamedTuple

import torch

from .launch_args import c_floats, carve

N_STATE = 15                 # tracker.N_STATE
N_HIST = 6                   # tracker.N_HIST
KERNEL_MAX_ROWS = 256        # kMaxRows: track slots, detections, history

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# (dtype, trailing shape) of the state's and the history's fields; 'F' is
# the feature width, 'K' the keypoints a track
STATE_SPEC = ((_F32, (8,)), (_F32, (8, 8)), (_F32, (4,)), (_BOOL, ()),
              (_I32, ()), (_I32, ()), (_I32, ()), (_I32, ()), (_I32, ()),
              (_BOOL, ()), (_F32, ()), (_F32, ('K', 2)), (_BOOL, ('K',)),
              (_F32, ('F',)), (_F32, ()))
HIST_SPEC = ((_F32, ('F',)), (_F32, ()), (_I32, ()), (_BOOL, ()),
             (_I32, ()), (_I32, ()))

FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entries (the card's build or the tests' host build) with
    their C signatures declared."""
    lib.assoc_commit_forward.argtypes = FORWARD_ARGTYPES
    lib.assoc_commit_forward.restype = ctypes.c_int
    lib.assoc_commit_error_string.argtypes = [ctypes.c_int]
    lib.assoc_commit_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def assoc_commit_library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from .cuda_build import load
    return declare(load('assoc_commit'))


# (bytes an element, rows: 'T' the slots, 'D' the detections, 'H' the
# history or 1, elements a row) of each input the decisions' block stages
# in dynamic shared memory (staged_field in csrc/assoc_commit.cu)
STAGED_FIELDS = ((4, 'T', 4), (1, 'T', 1), *((4, 'T', 1),) * 5, (1, 'T', 1),
                 *((4, 'T', 1),) * 4, (4, 'H', 1), (4, 'H', 1), (1, 'H', 1),
                 *((4, 'H', 1),) * 3, (4, 'D', 4), (4, 'D', 1),
                 *((1, 'D', 1),) * 3, (4, 1, 4), (4, 'T', 8), (4, 'T', 64))


def staged_bytes(t: int, d: int, h: int) -> int:
    """Bytes of dynamic shared memory the decisions' block stages its
    stream's inputs in (``staged_layout`` in csrc/assoc_commit.cu): each
    field at a 16-byte boundary."""
    rows = {'T': t, 'D': d, 'H': h, 1: 1}
    return sum(-(-rows[r] * w * b // 16) * 16 for b, r, w in STAGED_FIELDS)


def scratch_ints(n_tracks: int, n_hist: int) -> int:
    """int32 words of a stream's kernel scratch (``plan_ints`` in
    csrc/assoc_commit.cu): the wide rows' plan, 5 a track and a history
    row and 2 a track."""
    return 5 * (n_tracks + n_hist) + 2 * n_tracks


def info_size(n_tracks: int, n_hist: int) -> int:
    """Length of an association frame's info vector (``tracker.
    _flat_info``'s layout, ``MultiTracker._assoc_layout``)."""
    return 4 + 90 * n_tracks + n_hist


def _fault(msg):
    raise ValueError(f'assoc_commit: {msg}')


def _stream(device: torch.device):
    return torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None


def _shape(trail, lead, sizes):
    return lead + tuple(sizes[x] if isinstance(x, str) else x
                        for x in trail)


def _expected(lead, t, d, h, f, k):
    """(name, dtype, shape) of each input, in the Ptr enum's order; ``lead``
    the stream axis, ``(S,)``, or ``()`` for one stream without it."""
    sizes = {'F': f, 'K': k}
    return tuple((f'state[{i}]', dtype, _shape(trail, lead + (t,), sizes))
                 for i, (dtype, trail) in enumerate(STATE_SPEC)) + tuple(
        (f'hist[{i}]', dtype, _shape(trail, lead + (h,), sizes))
        for i, (dtype, trail) in enumerate(HIST_SPEC)) + tuple(
        (name, dtype, lead + shape) for name, dtype, shape in (
            ('d_tlbrs', _F32, (d, 4)), ('d_labels', _I32, (d,)),
            ('d_valid', _BOOL, (d,)), ('d_emb', _F32, (d, f)),
            ('occluded', _BOOL, (d,)), ('col4row', _I32, (t,)),
            ('u_det_conf', _BOOL, (d,)), ('reid_c4r', _I32, (h,)),
            ('rect_c4r', _I32, (t,)))) + (('frame_tlbr', _F32, (4,)),)


class _Layout(NamedTuple):
    """What one kind of call needs, made once: the inputs' expected
    (dtype, shape, device), the entry's ints less the frame id,
    its float array (the Kalman filter's constants), and ``carve``'s parts:
    each output's (dtype, shape) (the new state's fields, the new
    history's, the info), then the kernel's scratch in bytes."""
    signature: list
    ints: tuple
    floats: ctypes.Array
    parts: tuple


_PTRS = ctypes.c_uint64 * 54      # the Ptr enum's pointers
_INTS = ctypes.c_int * 10         # the Int enum's values
_DATA_PTR = torch.Tensor.data_ptr
_SIGNATURE = operator.attrgetter('dtype', 'shape', 'device')
_CONTIGUOUS = torch.Tensor.is_contiguous


@functools.cache
def _layout(key, device):
    (lead, t, d, h, f, k, confirm_hits, max_age, history_size, kf) = key
    s = lead[0] if lead else 1
    if not (1 <= t <= KERNEL_MAX_ROWS and 1 <= d <= KERNEL_MAX_ROWS
            and 1 <= h <= KERNEL_MAX_ROWS):
        _fault(f'{t} track slots, {d} detections and {h} history slots: '
               f'the kernel takes 1 to {KERNEL_MAX_ROWS} of each')
    if s < 1 or f < 1 or k < 1:
        _fault(f'{s} streams, feature width {f}, {k} keypoints a track')
    sizes = {'F': f, 'K': k}
    parts = tuple((dtype, _shape(trail, lead + (t,), sizes))
                  for dtype, trail in STATE_SPEC) + tuple(
        (dtype, _shape(trail, lead + (h,), sizes))
        for dtype, trail in HIST_SPEC) + (
        (_F32, lead + (info_size(t, h),)), 4 * s * scratch_ints(t, h))
    return _Layout(
        [(dtype, torch.Size(shape), device) for _, dtype, shape in
         _expected(lead, t, d, h, f, k)],
        (s, t, d, h, f, k, confirm_hits, max_age, history_size),
        c_floats(kf.std_factor_det[0], kf.std_factor_det[1],
                 kf.min_std_det[0], kf.min_std_det[1], kf.init_pos_weight,
                 kf.init_vel_weight),
        parts)


def _check_each(inputs, expected, device):
    for x, (name, dtype, shape) in zip(inputs, expected):
        if not isinstance(x, torch.Tensor):
            _fault(f'{name} is not a tensor')
        if x.dtype != dtype:
            _fault(f'{name} is {x.dtype}, expected {dtype}')
        if tuple(x.shape) != tuple(shape):
            _fault(f'{name} is {tuple(x.shape)}, expected {tuple(shape)}')
        if x.device != device:
            _fault(f'{name} is on {x.device}, means on {device}')
        if not x.is_contiguous():
            _fault(f'{name} is not contiguous')


def commit_launch_args(cfg, confirm_hits: int, max_age: int,
                       history_size: int, states, hists, dets, embs,
                       frame_id: int, frame_tlbr, cascade_out):
    """One kernel call as ``assoc_commit_forward`` takes it: ``(outputs,
    args)``, the outputs (new states, new hists, infos [S, n_info]) and the
    entry's argument tuple writing them (on the current CUDA stream for
    CUDA tensors). The arguments are ``commit_batch``'s: ``states`` the 15
    state fields [S, T, ...], ``hists`` the 6 history fields [S, H, ...],
    ``dets`` (tlbr [S, D, 4], label [S, D] int32, conf, valid [S, D]),
    ``embs`` [S, D, F] float32, ``cascade_out`` (occluded [S, D], col4row
    [S, T] int32, u_det_conf [S, D], reid_c4r [S, H] int32, rect_c4r [S, T]
    int32), ``frame_tlbr`` [4] float32; or ``commit_part``'s, one stream
    without the stream axis (``means`` [T, 8]), and then the outputs have
    none either. Raises ValueError on a wrong dtype, shape or device, a
    tensor that is not contiguous, or sizes the kernel does not take. The
    arguments hold the tensors' addresses, so they serve as long as the
    outputs and the inputs live; the outputs are views of one float32, one
    int32 and one bool buffer, which also holds the kernel's scratch. The
    common case checks the inputs with one comparison of their (dtype,
    shape, device, contiguous) against those of a call of the same sizes,
    made once."""
    if len(states) != N_STATE or len(hists) != N_HIST:
        _fault(f'{len(states)} state and {len(hists)} history fields, '
               f'expected {N_STATE} and {N_HIST}')
    means, hist_sum, kps = states[0], hists[0], states[11]
    try:
        lead = tuple(means.shape[:-2])
        ok = len(lead) <= 1 and hist_sum.dim() == embs.dim() == 2 + \
            len(lead) and kps.dim() == 3 + len(lead)
    except AttributeError:         # not a tensor
        ok = False
    if not ok:
        _fault('means [S, T, 8], kps [S, T, K, 2], hist_sum [S, H, F] and '
               'embs [S, D, F] expected, or the same without S')
    device = means.device
    t, h = means.shape[-2], hist_sum.shape[-2]
    d, f, k = embs.shape[-2], hist_sum.shape[-1], kps.shape[-2]
    occluded, col4row, u_det_conf, reid_c4r, rect_c4r = cascade_out
    inputs = (*states, *hists, dets[0], dets[1], dets[3], embs, occluded,
              col4row, u_det_conf, reid_c4r, rect_c4r, frame_tlbr)
    layout = _layout((lead, t, d, h, f, k, int(confirm_hits), int(max_age),
                      int(history_size), cfg), device)
    try:
        ok = list(map(_SIGNATURE, inputs)) == layout.signature \
            and all(map(_CONTIGUOUS, inputs))
    except (AttributeError, TypeError):         # not a tensor
        ok = False
    if not ok:
        _check_each(inputs, _expected(lead, t, d, h, f, k), device)
    outs, addrs, _ = carve(device, layout.parts)
    args = (_PTRS.from_buffer(array.array(
                'Q', list(map(_DATA_PTR, inputs)) + addrs)),
            _INTS(*layout.ints, int(frame_id)), layout.floats,
            _stream(device))
    return (tuple(outs[:N_STATE]), tuple(outs[N_STATE:N_STATE + N_HIST]),
            outs[N_STATE + N_HIST]), args


def commit_reference(cfg, confirm_hits: int, max_age: int,
                     history_size: int, states, hists, dets, embs,
                     frame_id: int, frame_tlbr, cascade_out):
    """The plain version of ``assoc_commit``: ``tracker.commit_part`` for
    every stream under ``torch.func.vmap``, or on the one stream of
    tensors without the stream axis."""
    from torch.func import vmap

    from .. import tracker

    def one(state, hist, det, emb, casc):
        return tracker.commit_part(cfg, confirm_hits, max_age, history_size,
                                   state, hist, *det, emb, frame_id,
                                   frame_tlbr, casc)
    if states[0].dim() == 2:
        return one(states, hists, dets, embs, cascade_out)
    return vmap(one)(states, hists, dets, embs, cascade_out)


def assoc_commit(cfg, confirm_hits: int, max_age: int, history_size: int,
                 states, hists, dets, embs, frame_id: int, frame_tlbr,
                 cascade_out):
    """``tracker.commit_part`` for every stream of [S, ...] state and
    history: returns (new states, new hists, infos [S, n_info]); or for one
    stream without the stream axis (``commit_part``'s shapes, as
    ``tracker.commit_core`` calls it). On CUDA
    tensors one call of ``csrc/assoc_commit.cu``'s
    ``assoc_commit_forward`` (``commit_launch_args``' checks apply); on CPU
    tensors ``commit_reference``; any other device raises."""
    device = states[0].device
    if device.type == 'cpu':
        return commit_reference(cfg, confirm_hits, max_age, history_size,
                                states, hists, dets, embs, frame_id,
                                frame_tlbr, cascade_out)
    if device.type != 'cuda':
        raise ValueError(f'assoc_commit: unsupported device {device}')
    outputs, args = commit_launch_args(
        cfg, confirm_hits, max_age, history_size, states, hists, dets, embs,
        frame_id, frame_tlbr, cascade_out)
    lib = assoc_commit_library()
    code = lib.assoc_commit_forward(*args)
    if code:
        raise RuntimeError('assoc_commit kernel: '
                           + lib.assoc_commit_error_string(code).decode())
    _ASSOC_COMMIT.launches += 1
    return outputs


assoc_commit.launches = 0
# the count's owner, whatever a caller binds the module's name to
_ASSOC_COMMIT = assoc_commit
