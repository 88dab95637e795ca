"""The ReID network's input in a hand-written kernel: every box's crop of
its stream's frame, resized to OSNet's input, flipped from BGR to RGB and
normalised with ImageNet's mean and std.

``reid_crops`` is the entry ``feature_extractor.extract_core`` calls. On
CUDA tensors it runs ``csrc/reid_crops.cu`` (built at first use; one
launch, a block a band of 8 or 16 output rows of a crop, no host sync); on
CPU
tensors the plain version, ``reid_crops_reference`` (``crop_resize_batch``,
then the normalisation); any other device raises. The two agree bit for
bit, in float32 and, with ``out_dtype=torch.bfloat16``, rounded to bf16
(tests/test_torch_reid_crops.py). ``reid_crops.launches`` counts the
kernel's calls.

The crop reproduces the JAX package's arithmetic exactly: there it is two
bf16 matrix products with float32 sums whose weight matrices hold at most
two non-zero hat weights a row, so here it is the same two-tap blend
written as a gather, with the weights and the column pass's intermediate
rounded to bf16 where the JAX products round. The division by 255 is a
multiply by the float32 reciprocal, as torch's CUDA division by a Python
scalar computes it, so that the plain version rounds alike on every
device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .launch_args import c_floats, c_ints

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INV_255 = 1.0 / 255.0
MAX_OUT_W = 8192      # kMaxOutW: the column taps' table in shared memory
# csrc/reid_crops.cu's bands: the bytes of a band's kept column pass at
# most (kPassBytes, bf16 values), and the call's output rows (crops x oh)
# from which a block takes 16 output rows, not 8: on an H100 80GB HBM3
# (700 W) 8 were faster at 64 crops of 256 rows (16,384; 18.3 against
# 20.4 us) and 16 at 1,024 (262,144; 187.4 against 192.8 us, in bf16 167.2
# against 187.4), none measured between
PASS_BYTES = 24576
BAND_SWITCH_ROWS = 65536


def band_rows(n_crops: int, out_h: int) -> int:
    """Output rows a block of the kernel takes for ``n_crops`` crops of
    ``out_h`` rows."""
    return 16 if n_crops * out_h > BAND_SWITCH_ROWS else 8


def span_cap(out_w: int, band: int) -> int:
    """The source rows a band's kept column pass holds (``span_cap`` of the
    C entry); a band spanning more runs it a pixel."""
    return min(2 * band, PASS_BYTES // (out_w * 3 * 2))


def dynamic_smem(out_w: int, band: int) -> int:
    """A block's dynamic shared memory: the column and row taps (16 bytes
    each), then the kept column pass."""
    return (out_w + band) * 16 + span_cap(out_w, band) * out_w * 3 * 2


OUT_DTYPES = (torch.float32, torch.bfloat16)

FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entry (the card's build or the tests' host build) with its
    C signature declared."""
    lib.reid_crops_forward.argtypes = FORWARD_ARGTYPES
    lib.reid_crops_forward.restype = ctypes.c_int
    lib.reid_crops_error_string.argtypes = [ctypes.c_int]
    lib.reid_crops_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def reid_crops_library() -> ctypes.CDLL:
    """The built kernel library, its C signature declared once."""
    from .cuda_build import load
    return declare(load('reid_crops'))


@functools.cache
def imagenet_constants(device: torch.device):
    """ImageNet's float32 mean and std on ``device``, made once a device
    (a host copy, a sync on the card, the first time only)."""
    return (torch.tensor(IMAGENET_MEAN, device=device),
            torch.tensor(IMAGENET_STD, device=device))


def _taps(pos: torch.Tensor, n_in: int):
    """Two-tap hat weights of clamped source positions: (i0, i1, w0, w1)
    with w0 = 1 - frac, w1 = frac, both rounded to bf16."""
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    bf = torch.bfloat16
    return i0, i1, (1.0 - frac).to(bf).float(), frac.to(bf).float()


def crop_resize_batch(frame: torch.Tensor, tlbrs: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop each box (inclusive corners, floored and clamped to >= 0) and
    resize it to ``out_hw`` with half-pixel centres and edge clamping.
    frame [H, W, 3] (values exact in bf16, e.g. uint8), tlbrs [N, 4] ->
    [N, oh, ow, 3] float32. With a stream axis, frames [S, H, W, 3] and
    tlbrs [S, D, 4] -> [S * D, oh, ow, 3] in one gather, each box read
    from its own stream's frame."""
    if frame.dim() == 3:
        frame, tlbrs = frame[None], tlbrs[None]
    fh, fw = frame.shape[1], frame.shape[2]
    oh, ow = out_hw
    dev = frame.device
    sid = torch.arange(tlbrs.shape[0], device=dev).repeat_interleave(
        tlbrs.shape[1])[:, None, None]
    tlbrs = tlbrs.reshape(-1, 4)
    boxes = torch.clamp(torch.floor(tlbrs.float()), min=0.0)
    x0, y0 = boxes[:, 0], boxes[:, 1]
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    # the reciprocals' products: what torch's CUDA division by a Python
    # scalar computes (equal to the quotients at powers of two)
    us = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / ow)
    vs = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / oh)
    xs = torch.clamp(x0[:, None] + us[None, :] * w[:, None] - 0.5,
                     0.0, fw - 1.0)
    ys = torch.clamp(y0[:, None] + vs[None, :] * h[:, None] - 0.5,
                     0.0, fh - 1.0)
    xi0, xi1, wx0, wx1 = _taps(xs, fw)            # [N, ow]
    yi0, yi1, wy0, wy1 = _taps(ys, fh)            # [N, oh]
    img = frame.to(torch.bfloat16).float()

    def column_pass(rows):                        # rows [N, oh]
        r = rows[:, :, None]
        a = img[sid, r, xi0[:, None, :]]          # [N, oh, ow, 3]
        b = img[sid, r, xi1[:, None, :]]
        t = wx0[:, None, :, None] * a + wx1[:, None, :, None] * b
        return t.to(torch.bfloat16).float()

    return (wy0[:, :, None, None] * column_pass(yi0)
            + wy1[:, :, None, None] * column_pass(yi1))


def reid_crops_reference(frame: torch.Tensor, tlbrs: torch.Tensor,
                         out_hw: tuple[int, int],
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The plain version of ``reid_crops``: ``crop_resize_batch``, BGR ->
    RGB, x * (1 / 255), minus ImageNet's mean, over its std; in
    ``out_dtype`` (the float32 result rounded to bf16 for bf16)."""
    crops = crop_resize_batch(frame, tlbrs, out_hw)
    mean, std = imagenet_constants(crops.device)
    out = (crops.flip(-1) * INV_255 - mean) / std
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def _fault(msg):
    raise ValueError(f'reid_crops: {msg}')


def reid_crops_launch_args(frame: torch.Tensor, tlbrs: torch.Tensor,
                           out_hw: tuple[int, int],
                           out_dtype: torch.dtype = torch.float32,
                           band: int | None = None):
    """One call of ``reid_crops_forward``: ``(out, args, inputs)``.
    ``frame`` [H, W, 3] or [S, H, W, 3] uint8 or float32, ``tlbrs`` [N, 4]
    or [S, D, 4] float32 on the frame's device; ``out`` [N or S * D, oh, ow,
    3] of ``out_dtype`` (float32 or bf16) is written by the call (on the
    current CUDA stream for CUDA tensors), ``inputs`` are the (contiguous)
    tensors the arguments point at, to keep alive with ``out``. ``band``,
    the output rows a block takes (8 or 16), is ``band_rows``' pick unless
    given (the tests run both). Raises ValueError on a wrong dtype, shape
    or device, or an output wider than ``MAX_OUT_W``."""
    if not isinstance(frame, torch.Tensor) or frame.dim() not in (3, 4):
        _fault('frame must be [H, W, 3] or [S, H, W, 3]')
    if not isinstance(tlbrs, torch.Tensor):
        _fault('tlbrs is not a tensor')
    frames, boxes = (frame, tlbrs) if frame.dim() == 4 else \
        (frame[None], tlbrs[None])
    if frames.shape[-1] != 3 or frames.dtype not in (torch.uint8,
                                                     torch.float32):
        _fault(f'frames are {tuple(frames.shape)} {frames.dtype}: expected '
               '[..., 3] uint8 or float32')
    s, fh, fw = (int(x) for x in frames.shape[:3])
    if boxes.dim() != 3 or boxes.shape[0] != s or boxes.shape[2] != 4:
        _fault(f'boxes must be [{s}, D, 4] beside frames of {s} streams')
    if boxes.dtype != torch.float32:
        _fault(f'boxes are {boxes.dtype}, expected torch.float32')
    if boxes.device != frames.device:
        _fault(f'boxes are on {boxes.device}, frames on {frames.device}')
    oh, ow = (int(x) for x in out_hw)
    d = int(boxes.shape[1])
    if d < 1 or s * d > 65535 or oh < 1 or not 1 <= ow <= MAX_OUT_W:
        _fault(f'{s} x {d} crops of {oh} x {ow}: the kernel takes 1 to '
               f'65,535 crops of at least 1 x 1, at most {MAX_OUT_W} wide')
    if out_dtype not in OUT_DTYPES:
        _fault(f'output dtype {out_dtype}: float32 or bfloat16 expected')
    inputs = [frames.contiguous(), boxes.contiguous()]
    out = torch.empty((s * d, oh, ow, 3), dtype=out_dtype,
                      device=frames.device)
    stream = torch._C._cuda_getCurrentRawStream(frames.device.index) \
        if frames.device.type == 'cuda' else None
    args = ((ctypes.c_uint64 * 3)(inputs[0].data_ptr(), inputs[1].data_ptr(),
                                  out.data_ptr()),
            c_ints(s, d, fh, fw, oh, ow, int(frames.dtype == torch.float32),
                   int(out_dtype == torch.bfloat16),
                   band or band_rows(s * d, oh)),
            c_floats(1.0 / ow, 1.0 / oh), stream)
    return out, args, inputs


def reid_crops(frame: torch.Tensor, tlbrs: torch.Tensor,
               out_hw: tuple[int, int],
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """OSNet's input for every box: [N, oh, ow, 3] (``frame`` [H, W, 3] and
    ``tlbrs`` [N, 4]) or [S * D, oh, ow, 3] (frames [S, H, W, 3], tlbrs [S,
    D, 4], each box cropped from its own stream's frame), float32 or, with
    ``out_dtype=torch.bfloat16``, the float32 values rounded to bf16. On
    CUDA tensors one launch of ``csrc/reid_crops.cu``
    (``reid_crops_launch_args``' checks apply); on CPU tensors
    ``reid_crops_reference``; any other device raises."""
    device = frame.device
    if device.type == 'cpu':
        return reid_crops_reference(frame, tlbrs, out_hw, out_dtype)
    if device.type != 'cuda':
        raise ValueError(f'reid_crops: unsupported device {device}')
    out, args, _ = reid_crops_launch_args(frame, tlbrs, out_hw, out_dtype)
    lib = reid_crops_library()
    code = lib.reid_crops_forward(*args)
    if code:
        raise RuntimeError('reid_crops kernel: '
                           + lib.reid_crops_error_string(code).decode())
    _REID_CROPS.launches += 1
    return out


reid_crops.launches = 0
# the count's owner, whatever a caller binds the module's name to
_REID_CROPS = reid_crops
