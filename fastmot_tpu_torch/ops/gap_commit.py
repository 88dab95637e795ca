"""The post-LK half of a gap frame in hand-written kernels: RANSAC draws,
homography and per-track similarity RANSAC, Kalman warp/predict/update and
the commit, for every stream of a call.

``gap_commit`` is the entry the tracker's gap frames call. On CUDA tensors
it calls ``csrc/gap_commit.cu`` (built at first use: two launches, a
stream's homography and similarity fits spread over blocks, then its
Kalman slots; no host sync, the draws made on the device from each
stream's seed); on CPU tensors it runs the plain version,
``tracker.gap_commit_core`` (``tracker.gap_commit_batch`` for several
streams) with the draws of ``flow_kernels.ransac_draws`` /
``ransac_draws_batch``; any other device raises. Both give JAX's draws bit
for bit and its algebra within float32 rounding
(tests/test_torch_gap_commit.py). ``gap_commit.launches`` counts the
kernel's calls.
"""
from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import flow_kernels as fk

# csrc/gap_commit.cu's Ptr enum: the state fields it reads (N_STATE
# indices), then the flow inputs, the Kalman matrices and the frame
STATE_IN = (0, 1, 2, 3, 4, 5, 9, 10, 11, 12)
# the new state's fields the kernel writes; the others pass through
STATE_OUT = (0, 1, 2, 3, 9, 10, 11, 12)
N_STATE = 15                 # tracker.N_STATE, which asserts they agree
KERNEL_MAX_TRACKS = 256      # kMaxTracks
KERNEL_MAX_BG = 256          # kMaxBg
H_PARTS = 16                 # kHParts: the homography's blocks a stream

# (dtype, trailing shape) of each state field the kernel reads, by index
_STATE_SPEC = {0: (torch.float32, (8,)), 1: (torch.float32, (8, 8)),
               2: (torch.float32, (4,)), 3: (torch.bool, ()),
               4: (torch.int32, ()), 5: (torch.int32, ()),
               9: (torch.bool, ()), 10: (torch.float32, ()),
               11: (torch.float32, (fk.KP_PER_TRACK, 2)),
               12: (torch.bool, (fk.KP_PER_TRACK,))}


def info_size(n_tracks: int, n_bg: int) -> int:
    """Length of a gap frame's info vector (``tracker._flat_info``)."""
    return 10 + 12 * n_tracks + 5 * n_bg


def scratch_words(f_cap: int) -> int:
    """4-byte words of a stream's kernel scratch (``scratch_words`` in
    csrc/gap_commit.cu): the homography's counts [H_PARTS, HYP_H] and
    hypotheses [HYP_H, 9], and 7 words a flow track of the similarity's
    estimates."""
    return H_PARTS * fk.HYP_H + fk.HYP_H * 9 + 7 * f_cap


def _seeds(seeds) -> np.ndarray:
    return (np.asarray(list(seeds), np.int64).reshape(-1) & 0xFFFFFFFF) \
        .astype(np.uint32)


# gap_commit_forward's C signature: the pointers' and the seeds' arrays
# pass as ctypes arrays over array.array buffers (cheaper to fill)
FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                    ctypes.c_void_p]


@functools.cache
def gap_commit_library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from .cuda_build import load
    lib = load('gap_commit')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gap_commit_forward.argtypes = FORWARD_ARGTYPES
    lib.gap_commit_forward.restype = ci
    lib.gap_commit_draws.argtypes = [ctypes.POINTER(ctypes.c_uint32), ci, ci,
                                     vp, vp, vp]
    lib.gap_commit_draws.restype = ci
    lib.gap_commit_error_string.argtypes = [ci]
    lib.gap_commit_error_string.restype = ctypes.c_char_p
    return lib


def _stream(device: torch.device):
    return torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None


class _Layout(NamedTuple):
    """What one kind of call (sizes, device, constants) needs, made once:
    the inputs' expected (dtype, shape, device, contiguous), the entry's
    int and float arrays, the seeds' array type, the sizes of one float32
    and one bool buffer, and the outputs and the scratch in the Ptr
    enum's order as (buffer, shape, strides, element offset)."""
    signature: list
    ints: ctypes.Array
    floats: ctypes.Array
    seeds: type
    sizes: tuple
    outputs: tuple


_PTRS = ctypes.c_uint64 * 30            # the Ptr enum's pointers
_DTYPES = (torch.float32, torch.bool)   # the output buffers'
_ITEM = (4, 1)                          # their bytes an element


def _expected(n_streams, n_tracks, f_cap, n_points):
    """(name, dtype, shape) of each input, in the Ptr enum's order."""
    lead = (n_streams, n_tracks)
    return tuple((f'state[{i}]', _STATE_SPEC[i][0], lead + _STATE_SPEC[i][1])
                 for i in STATE_IN) + (
        ('inside', torch.float32, (n_streams, f_cap, 4)),
        ('f_tlbrs', torch.float32, (n_streams, f_cap, 4)),
        ('f_valid', torch.bool, (n_streams, f_cap)),
        ('forder', torch.int64, (n_streams, f_cap)),
        ('all_prev', torch.float32, (n_streams, n_points, 2)),
        ('all_cur', torch.float32, (n_streams, n_points, 2)),
        ('status', torch.bool, (n_streams, n_points)),
        ('trans', torch.float32, (8, 8)),
        ('acc_cov', torch.float32, (8, 8)),
        ('frame_tlbr', torch.float32, (4,)))


def _fault(msg):
    raise ValueError(f'gap_commit: {msg}')


@functools.cache
def _layout(key, device):
    """The _Layout of a call; raises ValueError on sizes the kernel does
    not take."""
    (n_streams, n_tracks, f_cap, n_points, inlier_thresh, confirm_hits,
     size, age_penalty, std_acc, offset_acc, std_klt, min_klt) = key
    lead = (n_streams, n_tracks)
    n_bg = n_points - f_cap * fk.KP_PER_TRACK
    if not 1 <= n_tracks <= KERNEL_MAX_TRACKS:
        _fault(f'{n_tracks} track slots: the kernel takes 1 to '
               f'{KERNEL_MAX_TRACKS}')
    if not 1 <= f_cap <= min(fk.MAX_FLOW_TRACKS, n_tracks):
        _fault(f'flow budget {f_cap}: the kernel takes 1 to '
               f'{min(fk.MAX_FLOW_TRACKS, n_tracks)}')
    if not 1 <= n_bg <= KERNEL_MAX_BG:
        _fault(f'{n_bg} background points: the kernel takes 1 to '
               f'{KERNEL_MAX_BG}')
    # the written state fields (STATE_OUT), the info, the scratch; each at
    # a multiple of 16 elements of its buffer (0: float32, 1: bool)
    sizes, outputs = [0, 0], []
    for i in STATE_OUT + ('info', 'scratch'):
        if i == 'info':
            buf, shape = 0, (n_streams, info_size(n_tracks, n_bg))
        elif i == 'scratch':
            buf, shape = 0, (n_streams, scratch_words(f_cap))
        else:
            buf, shape = (int(_STATE_SPEC[i][0] == torch.bool),
                          lead + _STATE_SPEC[i][1])
        strides = tuple(math.prod(shape[j + 1:]) for j in range(len(shape)))
        outputs.append((buf, shape, strides, sizes[buf]))
        sizes[buf] += -(-math.prod(shape) // 16) * 16
    ints = (n_streams, n_tracks, f_cap, n_points, inlier_thresh,
            confirm_hits, *size)
    floats = (age_penalty, std_acc, offset_acc, *std_klt, *min_klt)
    return _Layout(
        [(dtype, torch.Size(shape), device, True) for _, dtype, shape in
         _expected(n_streams, n_tracks, f_cap, n_points)],
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_float * len(floats))(*floats), ctypes.c_uint32 * n_streams,
        tuple(sizes), tuple(outputs))


def _check_each(inputs, n_streams, n_tracks, f_cap, n_points, device):
    """Raises ValueError on the first input of a wrong type, dtype, shape
    or device, or not contiguous."""
    for t, (name, dtype, shape) in zip(
            inputs, _expected(n_streams, n_tracks, f_cap, n_points)):
        if not isinstance(t, torch.Tensor):
            _fault(f'{name} is not a tensor')
        if t.dtype != dtype:
            _fault(f'{name} is {t.dtype}, expected {dtype}')
        if tuple(t.shape) != tuple(shape):
            _fault(f'{name} is {tuple(t.shape)}, expected {tuple(shape)}')
        if t.device != device:
            _fault(f'{name} is on {t.device}, means on {device}')
        if not t.is_contiguous():
            _fault(f'{name} is not contiguous')


def gap_commit_launch_args(cfg, spec: fk.FlowSpec, age_penalty: float,
                           confirm_hits: int, states, inside, f_tlbrs,
                           f_valid, forder, all_prev, all_cur, status, seeds,
                           trans, acc_cov, frame_tlbr):
    """One kernel call on tensors [S, ...] as ``gap_commit_forward`` takes
    it: ``(outputs, args)``, the new state's written fields (STATE_OUT
    order) and the info [S, n_info], and the entry's argument tuple writing
    them and the kernel's scratch (on the current CUDA stream for CUDA
    tensors). Raises ValueError on a wrong dtype, shape or device, a tensor
    that is not contiguous, or sizes the kernel does not take. The
    arguments hold the tensors' addresses, so they serve as long as the
    outputs and the inputs live. The outputs are views of one float32 and
    one bool buffer; the common case checks the inputs with one comparison
    of their (dtype, shape, device, contiguous) against those of a call of
    the same sizes and constants, made once."""
    if len(states) != N_STATE:
        _fault(f'{len(states)} state fields, expected {N_STATE}')
    means = states[0]
    if means.dim() != 3:
        _fault(f'means {tuple(means.shape)}: expected [S, T, 8]')
    device = means.device
    n_streams, n_tracks = means.shape[:2]
    f_cap = f_tlbrs.shape[1] if f_tlbrs.dim() == 3 else -1
    n_points = all_prev.shape[1] if all_prev.dim() == 3 else -1
    inputs = (states[0], states[1], states[2], states[3], states[4],
              states[5], states[9], states[10], states[11], states[12],
              inside, f_tlbrs, f_valid, forder, all_prev, all_cur, status,
              trans, acc_cov, frame_tlbr)
    key = (n_streams, n_tracks, f_cap, n_points, spec.inlier_thresh,
           confirm_hits, spec.size, age_penalty, cfg.std_factor_acc,
           cfg.std_offset_acc, cfg.std_factor_klt, cfg.min_std_klt)
    layout = _layout(key, device)
    try:
        ok = [(t.dtype, t.shape, t.device, t.is_contiguous())
              for t in inputs] == layout.signature
    except AttributeError:         # not a tensor
        ok = False
    if not ok:
        _check_each(inputs, n_streams, n_tracks, f_cap, n_points, device)
    seeds = [int(x) & 0xFFFFFFFF for x in seeds]
    if len(seeds) != n_streams:
        _fault(f'{len(seeds)} seeds for {n_streams} streams')

    bufs = [torch.empty(n, dtype=dtype, device=device)
            for n, dtype in zip(layout.sizes, _DTYPES)]
    base = [b.data_ptr() for b in bufs]
    outputs = tuple(bufs[b].as_strided(shape, strides, offset)
                    for b, shape, strides, offset in layout.outputs[:-1])
    ptrs = [t.data_ptr() for t in inputs] + [
        base[b] + _ITEM[b] * offset for b, _, _, offset in layout.outputs]
    args = (_PTRS.from_buffer(array.array('Q', ptrs)), layout.ints,
            layout.floats, layout.seeds.from_buffer(array.array('I', seeds)),
            _stream(device))
    return outputs, args


def _new_states(states, outputs):
    new = list(states)
    for i, t in zip(STATE_OUT, outputs):
        new[i] = t
    return tuple(new)


def gap_commit_reference(cfg, spec: fk.FlowSpec, age_penalty: float,
                         confirm_hits: int, states, inside, f_tlbrs, f_valid,
                         forder, all_prev, all_cur, status, seeds, trans,
                         acc_cov, frame_tlbr):
    """The plain version of ``gap_commit``: each stream's draws from its
    seed, then ``tracker.gap_commit_core`` (one stream) or
    ``tracker.gap_commit_batch`` (several)."""
    from .. import tracker
    seeds = [int(s) for s in _seeds(seeds)]
    f_cap, dev = f_tlbrs.shape[1], f_tlbrs.device
    if len(seeds) == 1:
        new, info = tracker.gap_commit_core(
            cfg, spec, age_penalty, confirm_hits,
            tuple(a[0] for a in states), inside[0], f_tlbrs[0], f_valid[0],
            forder[0], all_prev[0], all_cur[0], status[0],
            fk.ransac_draws(seeds[0], f_cap, dev), trans, acc_cov,
            frame_tlbr)
        return tuple(a[None] for a in new), info[None]
    return tracker.gap_commit_batch(
        cfg, spec, age_penalty, confirm_hits, states, inside, f_tlbrs,
        f_valid, forder, all_prev, all_cur, status,
        fk.ransac_draws_batch(seeds, f_cap, dev), trans, acc_cov, frame_tlbr)


def gap_commit(cfg, spec: fk.FlowSpec, age_penalty: float, confirm_hits: int,
               states, inside, f_tlbrs, f_valid, forder, all_prev, all_cur,
               status, seeds, trans, acc_cov, frame_tlbr):
    """RANSAC + Kalman warp/predict/update + validity commit of a gap frame
    for every stream: ``tracker.gap_commit_core``'s arguments with a
    leading stream axis [S, ...] (``trans``, ``acc_cov`` and
    ``frame_tlbr`` shared) and each stream's uint32 RANSAC seed in place of
    its draws. Returns (new states [S, ...], infos [S, n_info]). On CUDA
    tensors one call of ``csrc/gap_commit.cu``'s ``gap_commit_forward``
    (``gap_commit_launch_args``' checks apply); on CPU tensors
    ``gap_commit_reference``; any other device raises."""
    device = states[0].device
    if device.type == 'cpu':
        return gap_commit_reference(cfg, spec, age_penalty, confirm_hits,
                                    states, inside, f_tlbrs, f_valid, forder,
                                    all_prev, all_cur, status, seeds, trans,
                                    acc_cov, frame_tlbr)
    if device.type != 'cuda':
        raise ValueError(f'gap_commit: unsupported device {device}')
    outputs, args = gap_commit_launch_args(
        cfg, spec, age_penalty, confirm_hits, states, inside, f_tlbrs,
        f_valid, forder, all_prev, all_cur, status, seeds, trans, acc_cov,
        frame_tlbr)
    lib = gap_commit_library()
    code = lib.gap_commit_forward(*args)
    if code:
        raise RuntimeError('gap_commit kernel: '
                           + lib.gap_commit_error_string(code).decode())
    gap_commit.launches += 1
    return _new_states(states, outputs[:-1]), outputs[-1]


gap_commit.launches = 0


def kernel_draws(seeds, f_cap: int, device):
    """The kernel's own RANSAC draws for ``seeds`` on a CUDA ``device``:
    (u_h [S, HYP_H, 4], u_a [S, f_cap, HYP_A, 2]), those of
    ``flow_kernels.ransac_draws_batch`` bit for bit (chip_smoke.py phase
    17 and the card tests compare them)."""
    seeds = _seeds(seeds)
    n = seeds.size
    u_h = torch.empty((n, fk.HYP_H, 4), dtype=torch.float32, device=device)
    u_a = torch.empty((n, f_cap, fk.HYP_A, 2), dtype=torch.float32,
                      device=device)
    lib = gap_commit_library()
    code = lib.gap_commit_draws((ctypes.c_uint32 * n)(*seeds.tolist()), n,
                                f_cap, u_h.data_ptr(), u_a.data_ptr(),
                                _stream(u_h.device))
    if code:
        raise RuntimeError('gap_commit draws: '
                           + lib.gap_commit_error_string(code).decode())
    return u_h, u_a
