"""The association frame's costs in hand-written kernels: every cascade
stage's cost matrix and row mask of ``tracker.assoc_costs_reference`` for
every stream of a call.

``assoc_costs`` is the entry the tracker's association frames call on the
card (``tracker.assoc_costs_core`` for one stream, ``tracker.
assoc_costs_batch`` for a stream axis): one call of ``csrc/assoc_costs.cu``
(built at first use): a launch that does each row's and each detection's
work once, then, behind it by a programmatic dependent launch, a block a
tile of 16 rows by 16 detections and a stream; no host sync. It takes
every tensor with a leading stream axis, or every one without (one
stream), and returns ``assoc_costs_reference``'s tuple likewise
(``depth_masks`` a tuple of [S, T] or [T] views). On any device but the
card it raises: the tracker runs the plain version on the CPU. The
masks, the occlusion, the IoU cost and the label gate equal the plain
version's bit for bit; the appearance and Mahalanobis terms agree within
float32 rounding (tests/test_torch_assoc_costs.py).
``assoc_costs.launches`` counts the calls.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .assignment import CHI_SQ_INV_95
from .distance import Metric
from .launch_args import c_floats, c_ints, carve

KERNEL_MAX_D = 256          # kMaxD in csrc/assoc_costs.cu
KERNEL_MAX_F = 2048
# the gate's 1 / chi-square quantile, rounded to float32
INV_CHI = float(np.float32(1.0) / np.float32(CHI_SQ_INV_95))

FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entries (the card's build or the tests' host build) with
    their C signatures declared."""
    lib.assoc_costs_forward.argtypes = FORWARD_ARGTYPES
    lib.assoc_costs_forward.restype = ctypes.c_int
    lib.assoc_costs_scratch_words.argtypes = [ctypes.c_int] * 6
    lib.assoc_costs_scratch_words.restype = ctypes.c_size_t
    lib.assoc_costs_error_string.argtypes = [ctypes.c_int]
    lib.assoc_costs_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def assoc_costs_library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from .cuda_build import load
    return declare(load('assoc_costs'))


def _fault(msg):
    raise ValueError(f'assoc_costs: {msg}')


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype \
            or t.shape != shape or t.device != device:
        if not isinstance(t, torch.Tensor):
            _fault(f'{name} is not a tensor')
        if t.dtype != dtype:
            _fault(f'{name} is {t.dtype}, expected {dtype}')
        if tuple(t.shape) != tuple(shape):
            _fault(f'{name} is {tuple(t.shape)}, expected {tuple(shape)}')
        if t.device != device:
            _fault(f'{name} is on {t.device}, expected {device}')
    return t if t.is_contiguous() else t.contiguous()


def assoc_costs_launch_args(cfg, metric, n_depth: int, motion_weight: float,
                            max_assoc_cost: float, iou_gate: float,
                            fill_val: float, occlusion_thresh: float,
                            confirm_hits: int, states, hists, dets, d_emb,
                            emb_cap: int | None = None, appearance=None,
                            lib: ctypes.CDLL | None = None):
    """One call of ``assoc_costs_forward``: ``(outputs, args, inputs)``.
    The arguments are ``tracker.assoc_costs_reference``'s, every tensor
    with a leading stream axis [S, ...] or every one without (one stream;
    ``dets`` = (tlbr, label, conf, valid)). ``outputs`` = (cost [S, T, D],
    iou_cost, reid_cost [S, H, D], occluded [S, D], h_reid_ok [S, H],
    masks [n_depth + 2, S, T] bool (the depth masks, then base_iou_active
    and base_unconfirmed), col4row0 [S, T] int32), without the S axis for
    one stream, are written by the call (on the current CUDA stream for
    CUDA tensors), views of one allocation that also holds the scratch
    (``lib``'s ``assoc_costs_scratch_words``; ``lib`` defaults to the
    card's build); ``inputs`` are the (contiguous) tensors and that
    allocation the arguments point at, to keep alive with them. Raises
    ValueError on a wrong dtype, shape or device, or sizes the kernel does
    not take."""
    means = states[0]
    if not isinstance(means, torch.Tensor) or means.dim() not in (2, 3):
        _fault('states[0] (means) must be [S, T, 8] or [T, 8]')
    device = means.device
    lead = tuple(means.shape[:-2])     # (S,), or () for one stream
    s, t = (lead[0] if lead else 1), int(means.shape[-2])
    d_tlbrs = dets[0]
    if not isinstance(d_tlbrs, torch.Tensor) \
            or d_tlbrs.dim() != len(lead) + 2:
        _fault('dets[0] (tlbr) must be [S, D, 4] (or [D, 4])')
    d = int(d_tlbrs.shape[-2])
    if not isinstance(hists[0], torch.Tensor) \
            or hists[0].dim() != len(lead) + 2:
        _fault('hists[0] (the history features) must be [S, H, F] (or '
               '[H, F])')
    h, f = (int(x) for x in hists[0].shape[-2:])
    if not (1 <= s <= 65535 and t >= 1 and h >= 1
            and 1 <= d <= KERNEL_MAX_D and 1 <= f <= KERNEL_MAX_F):
        _fault(f'{s} streams of {t} tracks, {h} history rows, {d} '
               f'detections, {f} features: the kernel takes 1 to 65,535 '
               f'streams, up to {KERNEL_MAX_D} detections and '
               f'{KERNEL_MAX_F} features')
    metric = metric if isinstance(metric, Metric) else \
        Metric[str(metric).upper()]
    lt, lh, ld = lead + (t,), lead + (h,), lead + (d,)
    inputs = [_check(means, 'means', _F32, lt + (8,), device),
              _check(states[1], 'covs', _F32, lt + (8, 8), device),
              _check(states[2], 'tlbrs', _F32, lt + (4,), device),
              _check(states[3], 't_valid', _BOOL, lt, device),
              _check(states[4], 'ages', _I32, lt, device),
              _check(states[5], 'hits', _I32, lt, device),
              _check(states[6], 't_labels', _I32, lt, device),
              _check(states[13], 'feat_sum', _F32, lt + (f,), device),
              _check(states[14], 'feat_count', _F32, lt, device),
              _check(hists[0], 'hist_sum', _F32, lh + (f,), device),
              _check(hists[1], 'hist_count', _F32, lh, device),
              _check(hists[2], 'h_labels', _I32, lh, device),
              _check(hists[3], 'h_valid', _BOOL, lh, device),
              _check(d_tlbrs, 'd_tlbrs', _F32, ld + (4,), device),
              _check(dets[1], 'd_labels', _I32, ld, device),
              _check(dets[3], 'd_valid', _BOOL, ld, device),
              _check(d_emb, 'd_emb', _F32, ld + (f,), device)]
    if appearance is None:
        app = [None, None]
    else:
        app = [_check(appearance[0], 't_app', _F32, lt + (d,), device),
               _check(appearance[1], 'h_app', _F32, lh + (d,), device)]
        inputs += app
    # one allocation: the outputs, then the scratch
    lib = lib or assoc_costs_library()
    outputs, at, buf = carve(device, (
        (_F32, lt + (d,)), (_F32, lt + (d,)), (_F32, lh + (d,)),
        (_BOOL, ld), (_BOOL, lh), (_BOOL, (n_depth + 2,) + lt), (_I32, lt),
        4 * lib.assoc_costs_scratch_words(s, t, d, h, f,
                                          int(appearance is None))))
    outputs = tuple(outputs[:7])
    inputs.append(buf)
    ptrs = [x.data_ptr() for x in inputs[:17]] \
        + [0 if a is None else a.data_ptr() for a in app] + at
    stream = torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None
    args = ((ctypes.c_uint64 * len(ptrs))(*ptrs),
            c_ints(s, t, d, h, f, n_depth, confirm_hits,
                   d if emb_cap is None else min(emb_cap, d),
                   int(metric == Metric.COSINE)),
            c_floats(1.0 - motion_weight, motion_weight, INV_CHI,
                     CHI_SQ_INV_95, max_assoc_cost, iou_gate, fill_val,
                     occlusion_thresh, cfg.std_factor_det[0],
                     cfg.std_factor_det[1], cfg.min_std_det[0],
                     cfg.min_std_det[1]),
            stream)
    return outputs, args, inputs


def assoc_costs(cfg, metric, n_depth: int, motion_weight: float,
                max_assoc_cost: float, iou_gate: float, fill_val: float,
                occlusion_thresh: float, confirm_hits: int, states, hists,
                dets, d_emb, emb_cap: int | None = None, appearance=None):
    """``tracker.assoc_costs_reference`` for every stream of a call in one
    call of ``csrc/assoc_costs.cu`` (two launches), on CUDA tensors with a
    leading stream axis, or without one for one stream
    (``assoc_costs_launch_args``' checks apply): (cost, iou_cost,
    reid_cost, occluded, h_reid_ok, depth_masks, base_iou_active,
    base_unconfirmed, d_valid, col4row0), each [S, ...] or without S.
    Raises on any other device, or if the kernels cannot be built or
    launched."""
    if states[0].device.type != 'cuda':
        raise ValueError(f'assoc_costs: unsupported device '
                         f'{states[0].device} (the kernel runs on CUDA '
                         'tensors; tracker.assoc_costs_reference elsewhere)')
    lib = assoc_costs_library()
    (cost, iou_cost, reid, occluded, h_reid_ok, masks, col4row), args, _ = \
        assoc_costs_launch_args(cfg, metric, n_depth, motion_weight,
                                max_assoc_cost, iou_gate, fill_val,
                                occlusion_thresh, confirm_hits, states, hists,
                                dets, d_emb, emb_cap, appearance, lib)
    code = lib.assoc_costs_forward(*args)
    if code:
        raise RuntimeError('assoc_costs kernel: '
                           + lib.assoc_costs_error_string(code).decode())
    _ASSOC_COSTS.launches += 1
    *depth, base_iou_active, base_unconfirmed = masks.unbind(0)
    return (cost, iou_cost, reid, occluded, h_reid_ok, tuple(depth),
            base_iou_active, base_unconfirmed, dets[3], col4row)


assoc_costs.launches = 0
# the count's owner, whatever a caller binds the module's name to
_ASSOC_COSTS = assoc_costs
