"""The detectors' data-dependent loops in hand-written kernels: the greedy
NMS waves (``geometry.greedy_suppress``) and the SSD merge's min-label
propagation (``merge_labels``).

On CUDA tensors both run ``csrc/nms_waves.cu`` (built at first use): the
NMS in two launches (the overlap packed into bits by many blocks, then a
block a problem runs the waves to the end), the merge in one launch (a
block a problem runs the rounds to the fixpoint), with no host sync. On
CPU tensors they run the plain versions, ``geometry.
greedy_suppress_reference`` and ``merge_labels_reference``, whose loops run
in Python over tensor ops and read a flag back once a wave or a round; any
other device raises. The two agree bit for bit
(tests/test_torch_nms_kernel.py). ``geometry.greedy_suppress.launches`` and
``merge_labels.launches`` count the kernels' calls.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

KERNEL_MAX_N = 1024        # kMaxN in csrc/nms_waves.cu: a problem's boxes

SUPPRESS_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
MERGE_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                  ctypes.c_void_p]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entries (the card's build or the tests' host build) with
    their C signatures declared."""
    lib.greedy_suppress_forward.argtypes = SUPPRESS_ARGTYPES
    lib.greedy_suppress_forward.restype = ctypes.c_int
    lib.merge_labels_forward.argtypes = MERGE_ARGTYPES
    lib.merge_labels_forward.restype = ctypes.c_int
    lib.nms_waves_error_string.argtypes = [ctypes.c_int]
    lib.nms_waves_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def nms_waves_library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from .cuda_build import load
    return declare(load('nms_waves'))


def _fault(msg):
    raise ValueError(f'nms_waves: {msg}')


def _stream(device: torch.device):
    return torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None


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


def suppress_launch_args(overlap, scores, valid, thresh: float):
    """One call of the NMS waves as ``greedy_suppress_forward`` takes it:
    ``(keep, args, inputs)``. ``overlap`` [..., N, N] float32, ``scores``
    [..., N] float32, ``valid`` [..., N] bool, the leading axes independent
    problems; ``keep`` [..., N] bool is written by the call (on the current
    CUDA stream for CUDA tensors), ``inputs`` are the (contiguous) tensors
    the arguments point at, to keep alive with ``keep``. Raises ValueError
    on a wrong dtype, shape or device, or N above ``KERNEL_MAX_N``."""
    if not isinstance(overlap, torch.Tensor) or overlap.dim() < 2:
        _fault('overlap must be [..., N, N]')
    device, n = overlap.device, int(overlap.shape[-1])
    lead = tuple(overlap.shape[:-2])
    if not 1 <= n <= KERNEL_MAX_N:
        _fault(f'{n} boxes: the kernel takes 1 to {KERNEL_MAX_N}')
    inputs = [_check(overlap, 'overlap', torch.float32, lead + (n, n),
                     device),
              _check(scores, 'scores', torch.float32, lead + (n,), device),
              _check(valid, 'valid', torch.bool, lead + (n,), device)]
    b, words = math.prod(lead), (n + 31) // 32
    bits = torch.empty((b, words, n), dtype=torch.int32, device=device)
    keep = torch.empty(lead + (n,), dtype=torch.bool, device=device)
    inputs.append(bits)
    ptrs = [t.data_ptr() for t in inputs] + [keep.data_ptr()]
    args = ((ctypes.c_uint64 * 5)(*ptrs), (ctypes.c_int * 2)(b, n),
            (ctypes.c_float * 1)(thresh), _stream(device))
    return keep, args, inputs


def suppress_kernel(overlap, scores, valid, thresh: float):
    """The NMS keep mask through ``csrc/nms_waves.cu`` on CUDA tensors
    (``suppress_launch_args``' checks apply); raises if the kernel cannot
    be built or launched."""
    keep, args, _ = suppress_launch_args(overlap, scores, valid, thresh)
    lib = nms_waves_library()
    code = lib.greedy_suppress_forward(*args)
    if code:
        raise RuntimeError('greedy_suppress kernel: '
                           + lib.nms_waves_error_string(code).decode())
    return keep


def merge_launch_args(edge, valid):
    """One call of the merge's propagation as ``merge_labels_forward``
    takes it: ``(labels, args, inputs)`` as ``suppress_launch_args``';
    ``edge`` [..., N, N] bool, ``valid`` [..., N] bool, ``labels`` [..., N]
    int64."""
    if not isinstance(edge, torch.Tensor) or edge.dim() < 2:
        _fault('edge must be [..., N, N]')
    device, n = edge.device, int(edge.shape[-1])
    lead = tuple(edge.shape[:-2])
    if not 1 <= n <= KERNEL_MAX_N:
        _fault(f'{n} rows: the kernel takes 1 to {KERNEL_MAX_N}')
    inputs = [_check(edge, 'edge', torch.bool, lead + (n, n), device),
              _check(valid, 'valid', torch.bool, lead + (n,), device)]
    labels = torch.empty(lead + (n,), dtype=torch.int64, device=device)
    ptrs = [t.data_ptr() for t in inputs] + [labels.data_ptr()]
    args = ((ctypes.c_uint64 * 3)(*ptrs),
            (ctypes.c_int * 2)(math.prod(lead), n), _stream(device))
    return labels, args, inputs


def merge_labels_reference(edge, valid):
    """The plain version of ``merge_labels``: the rounds a Python loop over
    tensor ops, one host sync a round."""
    n = edge.shape[-1]
    idx = torch.arange(n, device=edge.device)
    lbl = torch.where(valid, idx, n)
    while True:
        nbr_min = torch.where(edge, lbl[..., None, :], n).amin(dim=-1)
        new = torch.minimum(lbl, nbr_min)
        if not bool((new != lbl).any()):
            return lbl
        lbl = new


def merge_labels(edge, valid):
    """The least label of each row's component of ``edge`` (``edge[i, j]``:
    row i takes row j's label; symmetric in the SSD merge): every valid row
    starts at its index and every other row at N, and each round sets each
    label to the least of its own and its neighbours' until none changes,
    the JAX package's ``lax.while_loop`` at fastmot_tpu/detector.py:511.
    ``edge`` [..., N, N] bool, ``valid`` [..., N] bool; returns [..., N]
    int64. On CUDA tensors one launch of ``csrc/nms_waves.cu``'s
    ``merge_labels_forward`` (``merge_launch_args``' checks apply); on CPU
    tensors ``merge_labels_reference``; any other device raises."""
    device = edge.device
    if device.type == 'cpu':
        return merge_labels_reference(edge, valid)
    if device.type != 'cuda':
        raise ValueError(f'merge_labels: unsupported device {device}')
    labels, args, _ = merge_launch_args(edge, valid)
    lib = nms_waves_library()
    code = lib.merge_labels_forward(*args)
    if code:
        raise RuntimeError('merge_labels kernel: '
                           + lib.nms_waves_error_string(code).decode())
    _MERGE_LABELS.launches += 1
    return labels


merge_labels.launches = 0
# the count's owner, whatever a caller binds the module's name to
_MERGE_LABELS = merge_labels
