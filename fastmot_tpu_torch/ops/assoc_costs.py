"""The association frame's costs in a hand-written kernel: every cascade
stage's cost matrix and row mask of ``tracker.assoc_costs_reference`` for
every stream of a call.

``assoc_costs`` is the entry the tracker's association frames call on the
card (``tracker.assoc_costs_core`` for one stream, ``tracker.
assoc_costs_batch`` for a stream axis): one launch of
``csrc/assoc_costs.cu`` (built at first use; a block a tile of 16 track or
history rows and a stream), no host sync. It takes every tensor with a
leading stream axis and returns ``assoc_costs_reference``'s tuple with one
(``depth_masks`` a tuple of [S, T] views). On any device but the card it
raises: the tracker runs the plain version on the CPU. The masks, the
occlusion, the IoU cost and the label gate equal the plain version's bit
for bit; the appearance and Mahalanobis terms agree within float32
rounding (tests/test_torch_assoc_costs.py). ``assoc_costs.launches``
counts the kernel's calls.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .assignment import CHI_SQ_INV_95
from .distance import Metric

KERNEL_MAX_D = 256          # kMaxD in csrc/assoc_costs.cu
KERNEL_MAX_F = 2048

FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entries (the card's build or the tests' host build) with
    their C signatures declared."""
    lib.assoc_costs_forward.argtypes = FORWARD_ARGTYPES
    lib.assoc_costs_forward.restype = ctypes.c_int
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
    if not isinstance(t, torch.Tensor):
        _fault(f'{name} is not a tensor')
    if t.dtype != dtype:
        _fault(f'{name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        _fault(f'{name} is {tuple(t.shape)}, expected {tuple(shape)}')
    if t.device != device:
        _fault(f'{name} is on {t.device}, expected {device}')
    return t.contiguous()


def assoc_costs_launch_args(cfg, metric, n_depth: int, motion_weight: float,
                            max_assoc_cost: float, iou_gate: float,
                            fill_val: float, occlusion_thresh: float,
                            confirm_hits: int, states, hists, dets, d_emb,
                            emb_cap: int | None = None, appearance=None):
    """One call of ``assoc_costs_forward``: ``(outputs, args, inputs)``.
    The arguments are ``tracker.assoc_costs_reference``'s with a leading
    stream axis on every tensor (``dets`` = (tlbr, label, conf, valid)).
    ``outputs`` = (cost [S, T, D], iou_cost, reid_cost [S, H, D], occluded
    [S, D], h_reid_ok [S, H], masks [n_depth + 2, S, T] bool (the depth
    masks, then base_iou_active and base_unconfirmed), col4row0 [S, T]
    int32) are written by the call (on the current CUDA stream for CUDA
    tensors); ``inputs`` are the (contiguous) tensors the arguments point
    at, to keep alive with them. Raises ValueError on a wrong dtype, shape
    or device, or sizes the kernel does not take."""
    means = states[0]
    if not isinstance(means, torch.Tensor) or means.dim() != 3:
        _fault('states[0] (means) must be [S, T, 8]')
    device = means.device
    s, t = int(means.shape[0]), int(means.shape[1])
    d_tlbrs = dets[0]
    if not isinstance(d_tlbrs, torch.Tensor) or d_tlbrs.dim() != 3:
        _fault('dets[0] (tlbr) must be [S, D, 4]')
    d = int(d_tlbrs.shape[1])
    if not isinstance(hists[0], torch.Tensor) or hists[0].dim() != 3:
        _fault('hists[0] (the history features) must be [S, H, F]')
    h, f = (int(x) for x in hists[0].shape[1:])
    if not (1 <= s <= 65535 and t >= 1 and h >= 1
            and 1 <= d <= KERNEL_MAX_D and 1 <= f <= KERNEL_MAX_F):
        _fault(f'{s} streams of {t} tracks, {h} history rows, {d} '
               f'detections, {f} features: the kernel takes 1 to 65,535 '
               f'streams, up to {KERNEL_MAX_D} detections and '
               f'{KERNEL_MAX_F} features')
    metric = metric if isinstance(metric, Metric) else \
        Metric[str(metric).upper()]
    inputs = [_check(means, 'means', _F32, (s, t, 8), device),
              _check(states[1], 'covs', _F32, (s, t, 8, 8), device),
              _check(states[2], 'tlbrs', _F32, (s, t, 4), device),
              _check(states[3], 't_valid', _BOOL, (s, t), device),
              _check(states[4], 'ages', _I32, (s, t), device),
              _check(states[5], 'hits', _I32, (s, t), device),
              _check(states[6], 't_labels', _I32, (s, t), device),
              _check(states[13], 'feat_sum', _F32, (s, t, f), device),
              _check(states[14], 'feat_count', _F32, (s, t), device),
              _check(hists[0], 'hist_sum', _F32, (s, h, f), device),
              _check(hists[1], 'hist_count', _F32, (s, h), device),
              _check(hists[2], 'h_labels', _I32, (s, h), device),
              _check(hists[3], 'h_valid', _BOOL, (s, h), device),
              _check(d_tlbrs, 'd_tlbrs', _F32, (s, d, 4), device),
              _check(dets[1], 'd_labels', _I32, (s, d), device),
              _check(dets[3], 'd_valid', _BOOL, (s, d), device),
              _check(d_emb, 'd_emb', _F32, (s, d, f), device)]
    if appearance is None:
        app = [None, None]
    else:
        app = [_check(appearance[0], 't_app', _F32, (s, t, d), device),
               _check(appearance[1], 'h_app', _F32, (s, h, d), device)]
        inputs += app
    cost = torch.empty((2, s, t, d), dtype=_F32, device=device)
    reid = torch.empty((s, h, d), dtype=_F32, device=device)
    flags = torch.empty(s * d + s * h + (n_depth + 2) * s * t, dtype=_BOOL,
                        device=device)
    col4row = torch.empty((s, t), dtype=_I32, device=device)
    occluded = flags[:s * d].view(s, d)
    h_reid_ok = flags[s * d:s * d + s * h].view(s, h)
    masks = flags[s * d + s * h:].view(n_depth + 2, s, t)
    outputs = (cost[0], cost[1], reid, occluded, h_reid_ok, masks, col4row)
    ptrs = [x.data_ptr() for x in inputs[:17]] \
        + [0 if a is None else a.data_ptr() for a in app] \
        + [cost[0].data_ptr(), cost[1].data_ptr(), reid.data_ptr(),
           occluded.data_ptr(), h_reid_ok.data_ptr(), masks.data_ptr(),
           col4row.data_ptr()]
    inv_chi = float(np.float32(1.0) / np.float32(CHI_SQ_INV_95))
    stream = torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None
    args = ((ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_int * 9)(s, t, d, h, f, n_depth, confirm_hits,
                               d if emb_cap is None else min(emb_cap, d),
                               int(metric == Metric.COSINE)),
            (ctypes.c_float * 12)(
                1.0 - motion_weight, motion_weight, inv_chi, CHI_SQ_INV_95,
                max_assoc_cost, iou_gate, fill_val, occlusion_thresh,
                cfg.std_factor_det[0], cfg.std_factor_det[1],
                cfg.min_std_det[0], cfg.min_std_det[1]),
            stream)
    return outputs, args, inputs


def assoc_costs(cfg, metric, n_depth: int, motion_weight: float,
                max_assoc_cost: float, iou_gate: float, fill_val: float,
                occlusion_thresh: float, confirm_hits: int, states, hists,
                dets, d_emb, emb_cap: int | None = None, appearance=None):
    """``tracker.assoc_costs_reference`` for every stream of a call in one
    launch of ``csrc/assoc_costs.cu``, on CUDA tensors with a leading
    stream axis (``assoc_costs_launch_args``' checks apply): (cost,
    iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
    base_iou_active, base_unconfirmed, d_valid, col4row0), each [S, ...].
    Raises on any other device, or if the kernel cannot be built or
    launched."""
    if states[0].device.type != 'cuda':
        raise ValueError(f'assoc_costs: unsupported device '
                         f'{states[0].device} (the kernel runs on CUDA '
                         'tensors; tracker.assoc_costs_reference elsewhere)')
    (cost, iou_cost, reid, occluded, h_reid_ok, masks, col4row), args, _ = \
        assoc_costs_launch_args(cfg, metric, n_depth, motion_weight,
                                max_assoc_cost, iou_gate, fill_val,
                                occlusion_thresh, confirm_hits, states, hists,
                                dets, d_emb, emb_cap, appearance)
    lib = assoc_costs_library()
    code = lib.assoc_costs_forward(*args)
    if code:
        raise RuntimeError('assoc_costs kernel: '
                           + lib.assoc_costs_error_string(code).decode())
    _ASSOC_COSTS.launches += 1
    return (cost, iou_cost, reid, occluded, h_reid_ok,
            tuple(masks[:n_depth]), masks[n_depth], masks[n_depth + 1],
            dets[3], col4row)


assoc_costs.launches = 0
# the count's owner, whatever a caller binds the module's name to
_ASSOC_COSTS = assoc_costs
