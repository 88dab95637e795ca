"""The detectors' data-dependent loops in hand-written kernels: the greedy
NMS waves (``geometry.greedy_suppress``), the YOLO postprocess around them
(``nms_select``: the candidates' select, the DIoU and the order) and the
SSD merge's min-label propagation (``merge_labels``).

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

``nms_select`` is ``detector.nms_and_gate`` on the card: three launches (a
cluster of up to 8 blocks a stream selects the stable top K candidates by
a radix select over their scores' order bits, summed through distributed
shared memory, and places them by counting the keys above each; many
blocks compute the DIoU, same-label and greedy-order dominance bits from
the selected boxes; a block a stream runs the waves, the area and
aspect-ratio gates and the stable order by label and score), no host
sync and no [S, K, K] matrix. Its plain version is
``detector.nms_and_gate_reference``; the two agree bit for bit
(tests/test_torch_nms_select.py). ``nms_select.launches`` counts its
calls.

``ssd_postprocess`` is ``SSDDetector._postprocess_device`` on the card: two
launches (a block a tile computes the pixel boxes, the gates, the
same-label IoU and greedy-order dominance bits from the boxes and runs the
NMS waves; one block compacts the rows kept, builds the cross-tile IoM
edges among them from the boxes, propagates each component's least index,
collapses the components and places the rows by counting), no host sync
and no [n, n] matrix. Its plain version is
``detector.ssd_postprocess_reference``; the two agree bit for bit
(tests/test_torch_ssd_post.py). ``ssd_postprocess.launches`` counts its
calls.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .launch_args import c_floats, c_ints, carve

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
    lib.nms_select_forward.argtypes = SELECT_ARGTYPES
    lib.nms_select_forward.restype = ctypes.c_int
    lib.nms_select_scratch_words.argtypes = [ctypes.c_int] * 3
    lib.nms_select_scratch_words.restype = ctypes.c_size_t
    lib.ssd_postprocess_forward.argtypes = SELECT_ARGTYPES
    lib.ssd_postprocess_forward.restype = ctypes.c_int
    lib.ssd_postprocess_scratch_words.argtypes = [ctypes.c_int]
    lib.ssd_postprocess_scratch_words.restype = ctypes.c_size_t
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


SELECT_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]


def select_scratch_words(streams: int, n: int, k: int) -> int:
    """4-byte words of ``nms_select_forward``'s scratch (``select_layout``
    in csrc/nms_waves.cu): the keys [S, N] (to an even count), the
    selected candidates' int64 labels, boxes, two scores, overlap bits and
    validity bytes, [S, K] each (the boxes 4, the bits ceil(K / 32))."""
    bk = streams * k
    return ((streams * n + 1) // 2 * 2 + 2 * bk + 4 * bk + 2 * bk
            + (k + 31) // 32 * bk + (bk + 3) // 4)


def nms_select_launch_args(det_out, label_mask, conf_thresh: float,
                           nms_thresh: float, max_area: float, min_ar: float,
                           scale_wh, offset, keep: int, out: int):
    """One call of the YOLO postprocess as ``nms_select_forward`` takes it:
    ``(outputs, args, inputs)``. ``det_out`` [N, 7] or [S, N, 7] float32
    decoded rows, ``label_mask`` [L] bool, ``scale_wh`` [4] and ``offset``
    [2] float32, all on one device; ``keep`` (the candidates entering the
    NMS, at most ``KERNEL_MAX_N`` and N) and ``out`` (the outputs a
    stream, at most ``keep``). ``outputs`` = (tlbr [.., out, 4] float32,
    label [.., out] int32, conf [.., out] float32, valid [.., out] bool)
    are written by the call (on the current CUDA stream for CUDA tensors),
    views of one allocation that also holds the scratch; ``inputs`` are the
    (contiguous) tensors and that allocation the arguments point at, to
    keep alive with them. Raises ValueError on a wrong dtype, shape or
    device, or sizes out of range."""
    if not isinstance(det_out, torch.Tensor) or det_out.dim() not in (2, 3) \
            or det_out.shape[-1] != 7:
        _fault('det_out must be [N, 7] or [S, N, 7]')
    device = det_out.device
    lead = tuple(det_out.shape[:-2])
    n = int(det_out.shape[-2])
    s = math.prod(lead)
    if not 1 <= keep <= min(n, KERNEL_MAX_N) or not 1 <= out <= keep \
            or not 1 <= s <= 65535:
        _fault(f'{s} streams of {n} rows keeping {keep}, {out} out: the '
               f'kernel takes 1 to 65,535 streams, 1 <= out <= keep <= '
               f'min(N, {KERNEL_MAX_N})')
    if not isinstance(label_mask, torch.Tensor) or label_mask.dim() != 1 \
            or label_mask.numel() < 1:
        _fault('label_mask must be [L], L >= 1')
    inputs = [_check(det_out, 'det_out', torch.float32, det_out.shape,
                     device),
              _check(label_mask, 'label_mask', torch.bool,
                     label_mask.shape, device),
              _check(scale_wh, 'scale_wh', torch.float32, (4,), device),
              _check(offset, 'offset', torch.float32, (2,), device)]
    # one allocation: the outputs, then the scratch
    outputs, at, buf = carve(device, (
        (torch.float32, lead + (out, 4)), (torch.int32, lead + (out,)),
        (torch.float32, lead + (out,)), (torch.bool, lead + (out,)),
        4 * select_scratch_words(s, n, keep)))
    outputs = tuple(outputs[:4])
    inputs.append(buf)
    args = ((ctypes.c_uint64 * 9)(*(t.data_ptr() for t in inputs[:4]),
                                  at[4], *at[:4]),
            c_ints(s, n, keep, int(label_mask.numel()), out),
            c_floats(conf_thresh, nms_thresh, max_area, min_ar),
            _stream(device))
    return outputs, args, inputs


def nms_select(det_out, label_mask, conf_thresh: float, nms_thresh: float,
               max_area: float, min_ar: float, scale_wh, offset, keep: int,
               out: int):
    """``detector.nms_and_gate`` on CUDA tensors: three launches of
    ``csrc/nms_waves.cu``'s ``nms_select_forward`` (the select on a
    cluster of blocks a stream, the dominance bits from the selected boxes,
    the waves with the gates and the order), with no host sync and no [S,
    K, K] matrix (``nms_select_launch_args``' checks apply). Returns
    (tlbr, label, conf, valid), views of one allocation; raises if the
    kernels cannot be built or launched."""
    outputs, args, _ = nms_select_launch_args(
        det_out, label_mask, conf_thresh, nms_thresh, max_area, min_ar,
        scale_wh, offset, keep, out)
    lib = nms_waves_library()
    code = lib.nms_select_forward(*args)
    if code:
        raise RuntimeError('nms_select kernel: '
                           + lib.nms_waves_error_string(code).decode())
    _NMS_SELECT.launches += 1
    return outputs


nms_select.launches = 0
# the count's owner, whatever a caller binds the module's name to
_NMS_SELECT = nms_select


SSD_MAX_ROWS = KERNEL_MAX_N   # the SSD postprocess's tiles x rows at most


def ssd_scratch_words(n: int) -> int:
    """4-byte words of ``ssd_postprocess_forward``'s scratch for ``n``
    rows: each row's pixel box, conf and int label, then its validity
    bytes."""
    return 6 * n + (n + 3) // 4


def ssd_postprocess_launch_args(det_out, tiles_f, scale, label_mask,
                                conf_thresh: float, max_area: float,
                                merge_thresh: float, nms_thresh: float,
                                out: int):
    """One call of the SSD postprocess as ``ssd_postprocess_forward`` takes
    it: ``(outputs, args, inputs)``. ``det_out`` [T, K, 7] float32 decoded
    rows, ``tiles_f`` [T, 4] and ``scale`` [2] float32, ``label_mask`` [L]
    bool, all on one device; n = T x K rows, at most ``SSD_MAX_ROWS``;
    ``out`` the outputs (at most n); the three thresholds in [0, 1] and
    ``max_area`` >= 0. ``outputs`` = (tlbr [out, 4] float32, label [out]
    int32, conf [out] float32, keep [out] bool) are written by the call (on
    the current CUDA stream for CUDA tensors), views of one allocation that
    also holds the scratch; ``inputs`` are the (contiguous) tensors and
    that allocation the arguments point at, to keep alive with them. Raises
    ValueError on a wrong dtype, shape or device, sizes out of range or a
    threshold outside its range."""
    if not isinstance(det_out, torch.Tensor) or det_out.dim() != 3 \
            or det_out.shape[-1] != 7:
        _fault('det_out must be [T, K, 7]')
    device = det_out.device
    t, k = int(det_out.shape[0]), int(det_out.shape[1])
    n = t * k
    if not 1 <= n <= SSD_MAX_ROWS or not 1 <= out <= n:
        _fault(f'{t} tiles of {k} rows, {out} out: the kernel takes 1 to '
               f'{SSD_MAX_ROWS} rows in all and 1 <= out <= rows')
    for name, x in (('conf_thresh', conf_thresh),
                    ('merge_thresh', merge_thresh),
                    ('nms_thresh', nms_thresh)):
        if not 0.0 <= x <= 1.0:
            _fault(f'{name} {x} is outside [0, 1]')
    if not max_area >= 0:
        _fault(f'max_area {max_area} is negative')
    if not isinstance(label_mask, torch.Tensor) or label_mask.dim() != 1 \
            or label_mask.numel() < 1:
        _fault('label_mask must be [L], L >= 1')
    inputs = [_check(det_out, 'det_out', torch.float32, det_out.shape,
                     device),
              _check(tiles_f, 'tiles_f', torch.float32, (t, 4), device),
              _check(scale, 'scale', torch.float32, (2,), device),
              _check(label_mask, 'label_mask', torch.bool,
                     label_mask.shape, device)]
    # one allocation: the outputs, then the scratch
    outputs, at, buf = carve(device, (
        (torch.float32, (out, 4)), (torch.int32, (out,)),
        (torch.float32, (out,)), (torch.bool, (out,)),
        4 * ssd_scratch_words(n)))
    outputs = tuple(outputs[:4])
    inputs.append(buf)
    args = ((ctypes.c_uint64 * 9)(*(x.data_ptr() for x in inputs[:4]),
                                  at[4], *at[:4]),
            c_ints(t, k, int(label_mask.numel()), out),
            c_floats(conf_thresh, max_area, merge_thresh, nms_thresh),
            _stream(device))
    return outputs, args, inputs


def ssd_postprocess(det_out, tiles_f, scale, label_mask, conf_thresh: float,
                    max_area: float, merge_thresh: float, nms_thresh: float,
                    out: int):
    """``SSDDetector._postprocess_device`` on CUDA tensors: two launches of
    ``csrc/nms_waves.cu``'s ``ssd_postprocess_forward`` (the per-tile NMS a
    block a tile, then the merge and the order on one block), with no host
    sync and no [n, n] matrix (``ssd_postprocess_launch_args``' checks
    apply). Returns (tlbr, label, conf, keep), views of one allocation;
    raises if the kernels cannot be built or launched."""
    outputs, args, _ = ssd_postprocess_launch_args(
        det_out, tiles_f, scale, label_mask, conf_thresh, max_area,
        merge_thresh, nms_thresh, out)
    lib = nms_waves_library()
    code = lib.ssd_postprocess_forward(*args)
    if code:
        raise RuntimeError('ssd_postprocess kernel: '
                           + lib.nms_waves_error_string(code).decode())
    _SSD_POSTPROCESS.launches += 1
    return outputs


ssd_postprocess.launches = 0
# the count's owner, whatever a caller binds the module's name to
_SSD_POSTPROCESS = ssd_postprocess
