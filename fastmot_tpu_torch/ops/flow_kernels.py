"""Optical-flow ops on torch tensors: corners, pyramidal LK, RANSAC.

Port of ``fastmot_tpu/ops/flow_kernels.py``. The same fixed-budget,
masked formulation of cv2's GFTT / calcOpticalFlowPyrLK / findHomography /
estimateAffinePartial2D, with every numeric choice kept:

- the float32 image pyramid (bilinear resize to the flow scale, then 2x2
  means), with LK samples read from it rounded to uint8 and interpolated
  in float32; on the card ``preprocess`` is one launch of
  ``csrc/flow_preprocess.cu`` for all streams (the pyramid, its uint8
  rounding and both candidate grids), on the CPU
  ``preprocess_reference``;
- cv2's COUNT | EPS criteria: per point, at most ``iters`` Gauss-Newton
  steps per level, stopping once a step is below 0.03 px (the JAX
  package's lockstep "double step" computes exactly this). On the card
  ``lk_pyramidal`` is one launch of ``csrc/lk_pyramidal.cu`` (every
  level and step, no host sync; a tile of lanes a point, or one thread a
  point where the points fill the card); on the CPU it runs
  ``lk_pyramidal_reference``, the same loop in lockstep over all points;
- Shi-Tomasi response with one candidate per grid cell, the first
  row-major maximum winning ties;
- fixed-budget RANSAC (HYP_H homography and HYP_A similarity hypotheses)
  with guarded least-squares refinement.

Ranking uses stable sorts wherever the JAX package uses ``argsort`` or
``top_k`` (which also keep the lower index first on ties). RANSAC takes
its uniform draws ``u`` as arguments: the main path draws them with
``ransac_draws``, JAX's threefry-2x32 key derivation in numpy uint32
arithmetic on the host, so a seed gives the JAX package's uniforms bit
for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiler

MAX_FLOW_TRACKS = 128
KP_PER_TRACK = 32
BG_KP = 256
CELL = 8          # candidate-corner grid pitch (full-res pixels)
BG_CELL = 4       # candidate grid pitch on the bg-scale image
HYP_H = 256       # homography RANSAC hypotheses
HYP_A = 64        # per-track similarity RANSAC hypotheses
RANSAC_REPROJ = 3.0


def flow_budget(n_active: int) -> int:
    """Per-frame LK track budget: the smallest bucket covering the active
    track count (the JAX package's static kernel shapes)."""
    for b in (32, 48, 64, 96):
        if n_active <= b:
            return b
    return MAX_FLOW_TRACKS


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """Static flow configuration."""
    size: tuple[int, int]            # frame (W, H)
    opt_scale: tuple[float, float]   # optical-flow working scale
    bg_scale: tuple[float, float]    # background-detection scale
    win: int = 5
    max_level: int = 5
    iters: int = 10
    quality_level: float = 0.06
    max_error: float = 100.0
    feat_density: float = 0.005
    feat_dist_factor: float = 0.06
    ransac_iters: int = 500
    inlier_thresh: int = 4

    @property
    def opt_size(self):
        return (round(self.opt_scale[0] * self.size[0]),
                round(self.opt_scale[1] * self.size[1]))

    @property
    def bg_size(self):
        return (round(self.bg_scale[0] * self.size[0]),
                round(self.bg_scale[1] * self.size[1]))


# ---------------------------------------------------------------------------
# Image helpers
# ---------------------------------------------------------------------------

def _taps(n_in: int, n_out: int, device):
    """One axis of ``resize_bilinear``: each output sample's two source
    samples and their weights, as F.interpolate's bilinear resize
    (align_corners=False) takes them. The source coordinate float32(in /
    out) * (d + 0.5) - 0.5 is exact in float64 before its one rounding."""
    scale = float(np.float32(n_in) / np.float32(n_out))
    d = torch.arange(n_out, dtype=torch.float64, device=device)
    src = (scale * (d + 0.5) - 0.5).float().clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    w1 = (src - i0.float()).clamp(0.0, 1.0)
    i1 = i0 + (i0 < n_in - 1).long()
    return i0, i1, 1.0 - w1, w1


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """[..., h, w] float32 bilinear resize, half-pixel centres, edge clamp:
    F.interpolate's bilinear (align_corners=False, no antialias), the same
    two-tap hat weights as the JAX package's interpolation matrices. Along
    each row, then down each column, every product and sum rounded on its
    own (F.interpolate's CPU kernel fuses them, in an order that depends on
    the output's size), so the preprocess kernel takes one order at every
    size; where the weights are 0.5 (the 1/2 and 1/10 of a 1280x720 frame)
    every product is exact and the two agree bit for bit."""
    h, w = img.shape[-2:]
    y0, y1, wy0, wy1 = _taps(h, out_hw[0], img.device)
    x0, x1, wx0, wx1 = _taps(w, out_hw[1], img.device)

    def along_rows(rows):
        return rows[..., x0] * wx0 + rows[..., x1] * wx1

    return (along_rows(img[..., y0, :]) * wy0[:, None]
            + along_rows(img[..., y1, :]) * wy1[:, None])


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean (pyramid level step) of [..., h, w]."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    return img[..., :h2 * 2, :w2 * 2].reshape(
        img.shape[:-2] + (h2, 2, w2, 2)).mean(dim=(-3, -1))


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """Min-eigenvalue corner response with 3x3 gradient/window sums, of
    [..., h, w]."""
    img = img.float()
    ix = torch.zeros_like(img)
    iy = torch.zeros_like(img)
    ix[..., :, 1:-1] = (img[..., :, 2:] - img[..., :, :-2]) * 0.5
    iy[..., 1:-1, :] = (img[..., 2:, :] - img[..., :-2, :]) * 0.5

    def box3(x):
        xp = F.pad(x, (1, 1, 1, 1))
        s = xp[..., :-2, :] + xp[..., 1:-1, :] + xp[..., 2:, :]
        return s[..., :, :-2] + s[..., :, 1:-1] + s[..., :, 2:]

    sxx, syy, sxy = box3(ix * ix), box3(iy * iy), box3(ix * iy)
    # the float32 root rounded correctly, as XLA and the preprocess kernel
    # take it: ATen's vectorised CPU sqrt can be an ulp low (in about 0.7 %
    # of values), while a float32's root taken in float64 (itself within an
    # ulp) lies far inside a float32 rounding midpoint's distance
    det_term = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy ** 2,
                                      min=0.0).double()).float()
    return 0.5 * ((sxx + syy) - det_term)


def grid_candidates(resp: torch.Tensor, cell: int):
    """One candidate per ``cell`` x ``cell`` block: its maximum response
    and the first row-major pixel holding it. Returns (pts [..., G, 2] as
    (x, y), score [..., G]) in row-major cell order."""
    lead = resp.shape[:-2]
    h, w = resp.shape[-2:]
    gh, gw = h // cell, w // cell
    r = resp[..., :gh * cell, :gw * cell].reshape(lead + (gh, cell, gw, cell))
    r = r.transpose(-3, -2).reshape(lead + (gh, gw, cell * cell))
    score, idx = torch.max(r, dim=-1)      # first maximum on ties
    gy = torch.arange(gh, device=resp.device)[:, None]
    gx = torch.arange(gw, device=resp.device)[None, :]
    cy = gy * cell + idx // cell
    cx = gx * cell + idx % cell
    pts = torch.stack([cx.reshape(lead + (-1,)), cy.reshape(lead + (-1,))],
                      -1).float()
    return pts, score.reshape(lead + (-1,))


def in_box(pts: torch.Tensor, tlbr: torch.Tensor) -> torch.Tensor:
    """Inclusive point-in-box test."""
    return ((pts[..., 0] >= tlbr[..., 0]) & (pts[..., 0] <= tlbr[..., 2])
            & (pts[..., 1] >= tlbr[..., 1]) & (pts[..., 1] <= tlbr[..., 3]))


def preprocess_reference(spec: FlowSpec, frame: torch.Tensor):
    """The plain version of ``preprocess``: gray, ``resize_bilinear``,
    ``downsample2``, ``shi_tomasi_response`` and ``grid_candidates`` as
    eager torch ops."""
    f = frame.float()
    gray = f[..., 2] * 0.299 + f[..., 1] * 0.587 + f[..., 0] * 0.114
    ow, oh = spec.opt_size
    pyr = [resize_bilinear(gray, (oh, ow))]
    for _ in range(spec.max_level):
        pyr.append(downsample2(pyr[-1]))
    pyr_u8 = [torch.clamp(torch.round(p), 0.0, 255.0) for p in pyr]
    cand_pts, cand_score = grid_candidates(shi_tomasi_response(gray), CELL)
    bw, bh = spec.bg_size
    bg = resize_bilinear(gray, (bh, bw))
    bg_pts, bg_score = grid_candidates(shi_tomasi_response(bg), BG_CELL)
    bg_scale = torch.tensor(spec.bg_scale, dtype=torch.float32,
                            device=frame.device)
    return (pyr, pyr_u8, cand_pts, cand_score, bg_pts / bg_scale, bg_score)


# csrc/flow_preprocess.cu's limits: levels a 32 x 32 tile of level 0 holds
# (kMaxLevels), and the frames a launch takes (its grid's y extent)
PREPROCESS_MAX_LEVELS = 6
PREPROCESS_MAX_STREAMS = 65535
_ALIGN = 64                    # floats: each output starts 256 B aligned


@dataclasses.dataclass(frozen=True)
class _PreLayout:
    """One kind of preprocess call (spec, frame size, streams): the
    kernel's int and float arrays, the buffer's size in floats, and each
    output as (shape, strides, offset) in the state's order."""
    ints: ctypes.Array
    floats: ctypes.Array
    size: int
    outputs: tuple


@functools.cache
def _pre_layout(spec: FlowSpec, n_streams: int, h: int, w: int,
                stream_axis: bool) -> _PreLayout:
    def fault(msg):
        raise ValueError(f'preprocess: {msg}')

    n_levels = spec.max_level + 1
    if n_levels > PREPROCESS_MAX_LEVELS:
        fault(f'{n_levels} levels: the kernel takes at most '
              f'{PREPROCESS_MAX_LEVELS}')
    if not 1 <= n_streams <= PREPROCESS_MAX_STREAMS:
        fault(f'{n_streams} frames: the kernel takes 1 to '
              f'{PREPROCESS_MAX_STREAMS}')
    ow, oh = spec.opt_size
    bw, bh = spec.bg_size
    dims = [(oh, ow)]
    for _ in range(spec.max_level):
        dims.append((dims[-1][0] // 2, dims[-1][1] // 2))
    if min(min(d) for d in dims) < 1 or min(bh, bw) < 1:
        fault(f'level sizes {dims} and bg size {(bh, bw)}: every level '
              'must keep a pixel')
    g, gb = (h // CELL) * (w // CELL), (bh // BG_CELL) * (bw // BG_CELL)
    lead = (n_streams,) if stream_axis else ()
    shapes = ([lead + d for d in dims] * 2
              + [lead + (g, 2), lead + (g,), lead + (gb, 2), lead + (gb,)])
    outputs, size = [], 0
    for shape in shapes:
        strides = tuple(math.prod(shape[j + 1:]) for j in range(len(shape)))
        outputs.append((shape, strides, size))
        size += -(-n_streams * math.prod(shape[len(lead):]) // _ALIGN) \
            * _ALIGN
    offsets = [o for _, _, o in outputs]
    ints = (n_streams, h, w, n_levels, oh, ow, bh, bw,
            *(offsets[:n_levels] + [0] * (PREPROCESS_MAX_LEVELS - n_levels)),
            *(offsets[n_levels:2 * n_levels]
              + [0] * (PREPROCESS_MAX_LEVELS - n_levels)),
            *offsets[2 * n_levels:])
    if size >= 2 ** 31:
        fault(f'{size} floats of state: the kernel indexes at most 2^31')
    return _PreLayout((ctypes.c_int * len(ints))(*ints),
                      (ctypes.c_float * 2)(*spec.bg_scale), size,
                      tuple(outputs))


@functools.cache
def preprocess_library() -> ctypes.CDLL:
    """The built preprocess kernel library, its C signatures declared
    once."""
    from .cuda_build import load
    lib = load('flow_preprocess')
    vp = ctypes.c_void_p
    lib.flow_preprocess_forward.argtypes = [
        vp, vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        vp]
    lib.flow_preprocess_forward.restype = ctypes.c_int
    lib.flow_preprocess_error_string.argtypes = [ctypes.c_int]
    lib.flow_preprocess_error_string.restype = ctypes.c_char_p
    return lib


def preprocess_launch_args(spec: FlowSpec, frame: torch.Tensor):
    """One kernel call on ``frame`` ([H, W, 3] or [S, H, W, 3] uint8,
    contiguous) as ``flow_preprocess_forward`` takes it: ``(state, args)``,
    the state's tensors (views of one float32 buffer on the frame's device)
    and the entry's argument tuple writing them (on the current CUDA stream
    for a CUDA frame). Raises ValueError on a frame the kernel does not
    take. The arguments hold the tensors' addresses, so they serve as long
    as the frame and the state live."""
    if frame.dtype != torch.uint8 or frame.dim() not in (3, 4) \
            or frame.shape[-1] != 3:
        raise ValueError(f'preprocess: frames must be uint8 [H, W, 3] or '
                         f'[S, H, W, 3], got {frame.dtype} '
                         f'{tuple(frame.shape)}')
    if not frame.is_contiguous():
        raise ValueError('preprocess: the frames are not contiguous')
    stream_axis = frame.dim() == 4
    n_streams = frame.shape[0] if stream_axis else 1
    h, w = frame.shape[-3:-1]
    layout = _pre_layout(spec, int(n_streams), int(h), int(w), stream_axis)
    buf = torch.empty(layout.size, dtype=torch.float32, device=frame.device)
    views = [buf.as_strided(shape, strides, offset)
             for shape, strides, offset in layout.outputs]
    n_levels = spec.max_level + 1
    state = (views[:n_levels], views[n_levels:2 * n_levels],
             *views[2 * n_levels:])
    stream = torch._C._cuda_getCurrentRawStream(frame.device.index) \
        if frame.device.type == 'cuda' else None
    return state, (frame.data_ptr(), buf.data_ptr(), layout.ints,
                   layout.floats, stream)


def preprocess(spec: FlowSpec, frame: torch.Tensor):
    """[H, W, 3] uint8 BGR frame -> flow state ``(pyr, pyr_u8, cand_pts,
    cand_score, bg_pts, bg_score)``: the float32 pyramid, its levels
    rounded to uint8 values (kept as float32), the full-res corner
    candidates and the background candidates. A stack of frames [S, H,
    W, 3] gives the same state with a leading stream axis on every
    tensor. On a CUDA frame one launch of ``csrc/flow_preprocess.cu``
    (built at first use; ``preprocess_launch_args``' checks apply), the
    state views of one buffer; on a CPU frame ``preprocess_reference``;
    any other device raises. ``preprocess.launches`` counts the kernel's
    launches."""
    if frame.device.type == 'cpu':
        return preprocess_reference(spec, frame)
    if frame.device.type != 'cuda':
        raise ValueError(f'preprocess: unsupported device {frame.device}')
    state, args = preprocess_launch_args(spec, frame)
    lib = preprocess_library()
    code = lib.flow_preprocess_forward(*args)
    if code:
        raise RuntimeError('preprocess kernel: '
                           + lib.flow_preprocess_error_string(code).decode())
    preprocess.launches += 1
    return state


preprocess.launches = 0


def _topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Pyramidal Lucas-Kanade
# ---------------------------------------------------------------------------

def _sample_halo(img: torch.Tensor, sid: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, win: int) -> torch.Tensor:
    """[P, win+2, win+2] bilinear samples of ``img[sid]`` (img [S, h, w],
    uint8 values as float32; ``sid`` [P] the stream of each point) on the
    window around (x, y) plus a 1-px gradient halo: out[i, j] = sample(y -
    half - 1 + i, x - half - 1 + j). The taps are read edge-clamped and
    blended in float32."""
    h, w = img.shape[-2:]
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None, None]
    fy = (y - y0)[:, None, None]
    half = (win - 1) // 2
    offs = torch.arange(win + 3, device=img.device) - half - 1
    ys = torch.clamp(y0.long()[:, None] + offs, 0, h - 1)
    xs = torch.clamp(x0.long()[:, None] + offs, 0, w - 1)
    r = img[sid[:, None, None], ys[:, :, None], xs[:, None, :]]
    inner = win + 2
    p00 = r[:, :inner, :inner]
    p01 = r[:, :inner, 1:]
    p10 = r[:, 1:, :inner]
    p11 = r[:, 1:, 1:]
    return ((1 - fy) * (1 - fx) * p00 + (1 - fy) * fx * p01
            + fy * (1 - fx) * p10 + fy * fx * p11)


def lk_pyramidal_reference(prev_u8, cur_u8, pts: torch.Tensor,
                           valid: torch.Tensor, spec: FlowSpec,
                           trace: list | None = None):
    """The plain version of ``lk_pyramidal``: track ``pts`` [P, 2] (at
    optical-flow scale) from the previous to the current pyramid (lists of
    uint8-valued float32 levels).

    With a stream axis (levels [S, h, w], ``pts`` [S, P, 2], ``valid``
    [S, P]) every stream's points are tracked in one loop over one flat
    point set: the points are independent, and a point that has stopped is
    masked, so running until no point of any stream is active gives each
    stream what it would get alone.

    Per level, coarsest first: the 2x2 normal matrix comes from the
    template window's central-difference gradients (cv2's min-eigenvalue
    gate rejects flat windows); each still-active point takes a
    Gauss-Newton step of at most ``win`` px per axis until the step falls
    below 0.03 px or it has taken ``iters`` steps; the displacement seeds
    the next finer level, doubled. The patch error (mean absolute
    difference) is kept from each point's last step. Returns (new_pts,
    status, err).

    A ``trace`` list gets, per level, coarsest first, ``(level, p, trips)``
    over the flat [S * P] points: ``p`` [S * P, 2] the points at that
    level's scale, and ``trips`` a list of ``(p + v, active)``, the window
    centre of each Gauss-Newton trip and which points took that step."""
    if pts.dim() == 2:
        out = lk_pyramidal_reference([p[None] for p in prev_u8],
                                     [p[None] for p in cur_u8], pts[None],
                                     valid[None], spec, trace)
        return tuple(o[0] for o in out)
    n_streams, per_stream = pts.shape[:2]
    out_shape = pts.shape
    pts = pts.reshape(-1, 2)
    valid = valid.reshape(-1)
    n_levels = len(prev_u8)
    n_pts = pts.shape[0]
    wi = spec.win
    ww = wi * wi
    eps2 = 0.03 * 0.03
    dev = pts.device
    sid = torch.arange(n_streams, device=dev).repeat_interleave(per_stream)
    v = torch.zeros_like(pts)
    err = torch.zeros(n_pts, dtype=torch.float32, device=dev)
    ok = valid.clone()
    for lvl in range(n_levels - 1, -1, -1):
        p = pts * (2.0 ** -lvl)
        t_halo = _sample_halo(prev_u8[lvl], sid, p[:, 0], p[:, 1], wi)
        t_patch = t_halo[:, 1:wi + 1, 1:wi + 1].reshape(n_pts, ww)
        gx = (0.5 * (t_halo[:, 1:wi + 1, 2:wi + 2]
                     - t_halo[:, 1:wi + 1, 0:wi])).reshape(n_pts, ww)
        gy = (0.5 * (t_halo[:, 2:wi + 2, 1:wi + 1]
                     - t_halo[:, 0:wi, 1:wi + 1])).reshape(n_pts, ww)
        gxx = torch.sum(gx * gx, dim=1)
        gyy = torch.sum(gy * gy, dim=1)
        gxy = torch.sum(gx * gy, dim=1)
        det = gxx * gyy - gxy * gxy
        min_eig = 0.5 * (gxx + gyy - torch.sqrt(torch.clamp(
            (gxx - gyy) ** 2 + 4.0 * gxy ** 2, min=0.0)))
        inv_ok = min_eig / float(ww) > 1e-4
        det_safe = torch.where(det > 1e-12, det, torch.ones_like(det))

        active = valid.clone()
        steps = torch.zeros(n_pts, dtype=torch.int32, device=dev)
        trips = []
        if trace is not None:
            trace.append((lvl, p, trips))
        for _ in range(spec.iters):
            if trace is not None:
                trips.append((p + v, active))
            c_halo = _sample_halo(cur_u8[lvl], sid, p[:, 0] + v[:, 0],
                                  p[:, 1] + v[:, 1], wi)
            c_patch = c_halo[:, 1:wi + 1, 1:wi + 1].reshape(n_pts, ww)
            diff = t_patch - c_patch
            e = torch.mean(torch.abs(diff), dim=1)
            bx = torch.sum(diff * gx, dim=1)
            by = torch.sum(diff * gy, dim=1)
            dx = (gyy * bx - gxy * by) / det_safe
            dy = (gxx * by - gxy * bx) / det_safe
            step = torch.clamp(torch.stack([dx, dy], -1), -float(wi),
                               float(wi))
            err = torch.where(active, e, err)
            v = v + torch.where((active & inv_ok)[:, None], step,
                                torch.zeros_like(step))
            still = torch.sum(step * step, dim=1) >= eps2
            steps = steps + active.to(torch.int32)
            active = active & inv_ok & still & (steps < spec.iters)
            if not bool(active.any()):
                break
        ok = ok & inv_ok
        if lvl > 0:
            v = v * 2.0
    new_pts = pts + v
    h0, w0 = cur_u8[0].shape[-2:]
    inb = ((new_pts[:, 0] >= 0) & (new_pts[:, 0] <= w0 - 1)
           & (new_pts[:, 1] >= 0) & (new_pts[:, 1] <= h0 - 1))
    return (new_pts.reshape(out_shape), (ok & inb).reshape(out_shape[:2]),
            err.reshape(out_shape[:2]))


# the one window csrc/lk_pyramidal.cu is instantiated for (FlowSpec's
# default; its launch switch gains a case when a config needs another),
# and its largest level count (kMaxLevels)
LK_KERNEL_WIN = 5
LK_KERNEL_MAX_LEVELS = 12


@dataclasses.dataclass(frozen=True)
class LkLevels:
    """The kernel's view of one ``lk_pyramidal`` call: ``dims`` holds each
    level's (h, w), finest first; level ``l`` of stream ``s`` starts
    ``s * strides[l]`` floats into its tensor."""
    streams: int
    points: int
    dims: tuple[tuple[int, int], ...]

    @property
    def strides(self) -> tuple[int, ...]:
        return tuple(h * w for h, w in self.dims)


def lk_level_table(prev_u8, cur_u8, pts: torch.Tensor, valid: torch.Tensor,
                   spec: FlowSpec) -> LkLevels:
    """Check one ``lk_pyramidal`` call's arguments as the kernel takes them
    (``pts`` [S, P, 2] float32, ``valid`` [S, P] bool, ``spec.max_level +
    1`` levels each side, level ``l`` of both pyramids [S, h_l, w_l]
    float32, every tensor contiguous and on ``pts``' device) and return
    its level table. Raises ``ValueError`` naming the fault."""
    def fault(msg):
        raise ValueError(f'lk_pyramidal: {msg}')

    if pts.dtype != torch.float32 or pts.dim() != 3 or pts.shape[-1] != 2:
        fault(f'pts must be float32 [S, P, 2], got {pts.dtype} '
              f'{tuple(pts.shape)}')
    n_streams, n_points = pts.shape[:2]
    if valid.dtype != torch.bool:
        fault(f'valid must be bool, got {valid.dtype}')
    if tuple(valid.shape) != (n_streams, n_points):
        fault(f'valid has shape {tuple(valid.shape)}, pts '
              f'{tuple(pts.shape)}: stream or point counts differ')
    n_levels = spec.max_level + 1
    if len(prev_u8) != n_levels or len(cur_u8) != n_levels:
        fault(f'{len(prev_u8)} previous and {len(cur_u8)} current levels, '
              f'spec.max_level + 1 = {n_levels}')
    if n_levels > LK_KERNEL_MAX_LEVELS:
        fault(f'{n_levels} levels, the kernel takes at most '
              f'{LK_KERNEL_MAX_LEVELS}')
    if spec.win != LK_KERNEL_WIN:
        fault(f'window {spec.win}: the kernel is built for window '
              f'{LK_KERNEL_WIN} only')
    device = pts.device
    for name, t in (('pts', pts), ('valid', valid)):
        if t.device != device:
            fault(f'{name} is on {t.device}, pts on {device}')
        if not t.is_contiguous():
            fault(f'{name} is not contiguous')
    dims = []
    for lvl, (p, c) in enumerate(zip(prev_u8, cur_u8)):
        for side, t in (('previous', p), ('current', c)):
            shape = t.shape
            if t.dtype != torch.float32 or len(shape) != 3:
                fault(f'{side} level {lvl} must be float32 [S, h, w], got '
                      f'{t.dtype} {tuple(shape)}')
            if shape[0] != n_streams:
                fault(f'{side} level {lvl} has {shape[0]} streams, pts '
                      f'{n_streams}')
            if shape[1] < 1 or shape[2] < 1:
                fault(f'{side} level {lvl} is empty: {tuple(shape)}')
            if t.device != device:
                fault(f'{side} level {lvl} is on {t.device}, pts on {device}')
            if not t.is_contiguous():
                fault(f'{side} level {lvl} is not contiguous')
        if p.shape != c.shape:
            fault(f'level {lvl}: previous {tuple(p.shape)}, current '
                  f'{tuple(c.shape)}')
        dims.append((int(p.shape[1]), int(p.shape[2])))
    return LkLevels(int(n_streams), int(n_points), tuple(dims))


# the C entries of csrc/lk_pyramidal.cu by design: a tile of lanes a point,
# and one thread a point in blocks of LK_PER_THREAD_BLOCK (kThreads there)
LK_ENTRIES = {'tile': 'lk_pyramidal_forward',
              'per_thread': 'lk_pyramidal_forward_per_thread'}
LK_PER_THREAD_BLOCK = 128
# lk_design's threshold: the points a call needs per SM of the card for
# one thread a point to be the faster kernel. On an H100 (132 SMs) the one
# thread kernel takes 58-60 us up to 128 points an SM (a block of 128 on
# every SM), the tile kernel 30 us up to 16 and its time grows with the
# points, the two even at 10,240-11,264 points (78-85 an SM)
LK_PER_THREAD_POINTS_PER_SM = 80


def lk_design(n_points: int, n_sms: int) -> str:
    """The LK kernel for a call of ``n_points`` points (all streams) on a
    card of ``n_sms`` SMs: one thread a point from
    LK_PER_THREAD_POINTS_PER_SM points an SM on, the tile kernel below
    that. With few points the one-thread kernel's time is one point's
    serial chain, which the tile kernel shortens by spreading a point over
    lanes; with many the tile kernel's lanes repeat each point's scalar
    work and it is the slower (PERF.md section 6, chip_smoke.py phase
    16)."""
    return ('per_thread' if n_points >= LK_PER_THREAD_POINTS_PER_SM * n_sms
            else 'tile')


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def lk_library() -> ctypes.CDLL:
    """The built LK kernel library, its C signatures declared once."""
    from .cuda_build import load
    lib = load('lk_pyramidal')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in LK_ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(vp),
                       ctypes.POINTER(ci), ci, vp, vp, vp, vp, vp, ci, ci,
                       ci, ci, vp]
        fn.restype = ci
    for fn in (lib.lk_tile_lanes, lib.lk_tile_points):
        fn.argtypes = []
        fn.restype = ci
    lib.lk_error_string.argtypes = [ci]
    lib.lk_error_string.restype = ctypes.c_char_p
    return lib


def lk_launch_args(prev_u8, cur_u8, pts: torch.Tensor, valid: torch.Tensor,
                   spec: FlowSpec):
    """One kernel call on CUDA tensors [S, ...] as the C entries take it:
    ``(outputs, args)``, the new (new_pts, status, err) and the entries'
    argument tuple writing them on the current stream, after
    ``lk_level_table``'s checks. ``entry(*args)`` launches once; the
    arguments hold the tensors' addresses, so they serve as long as the
    tensors live (chip_smoke.py and the card tests launch and time either
    kernel with them)."""
    table = lk_level_table(prev_u8, cur_u8, pts, valid, spec)
    outputs = (torch.empty_like(pts), torch.empty_like(valid),
               torch.empty(valid.shape, dtype=torch.float32,
                           device=pts.device))
    n_levels = len(table.dims)
    ptrs = ctypes.c_void_p * n_levels
    args = (ptrs(*(t.data_ptr() for t in prev_u8)),
            ptrs(*(t.data_ptr() for t in cur_u8)),
            (ctypes.c_int * (2 * n_levels))(*(d for hw in table.dims
                                              for d in hw)),
            n_levels, pts.data_ptr(), valid.data_ptr(),
            *(t.data_ptr() for t in outputs), table.streams, table.points,
            spec.win, spec.iters,
            torch.cuda.current_stream(pts.device).cuda_stream)
    return outputs, args


def lk_pyramidal(prev_u8, cur_u8, pts: torch.Tensor, valid: torch.Tensor,
                 spec: FlowSpec):
    """Pyramidal LK (``lk_pyramidal_reference`` says what it computes):
    on CUDA tensors one launch of a kernel of ``csrc/lk_pyramidal.cu``,
    built at first use, which runs every level and every Gauss-Newton step
    of each point with no host sync: the kernel ``lk_design`` picks for the
    call's points and the card's SMs. On CPU tensors the plain version.
    Arguments and results as the plain version's (``pts`` [P, 2] or [S, P,
    2]); on the card ``lk_level_table``'s checks apply, and any other
    device raises. ``lk_pyramidal.launches[design]`` counts each kernel's
    launches."""
    if pts.device.type == 'cpu':
        return lk_pyramidal_reference(prev_u8, cur_u8, pts, valid, spec)
    if pts.device.type != 'cuda':
        raise ValueError(f'lk_pyramidal: unsupported device {pts.device}')
    if pts.dim() == 2:
        new_pts, ok, err = lk_pyramidal(
            [p[None] for p in prev_u8], [c[None] for c in cur_u8], pts[None],
            valid[None], spec)
        return new_pts[0], ok[0], err[0]
    outputs, args = lk_launch_args(prev_u8, cur_u8, pts, valid, spec)
    design = lk_design(valid.numel(), _sm_count(pts.device))
    lib = lk_library()
    code = getattr(lib, LK_ENTRIES[design])(*args)
    if code:
        raise RuntimeError('lk_pyramidal kernel: '
                           + lib.lk_error_string(code).decode())
    lk_pyramidal.launches[design] += 1
    return outputs


lk_pyramidal.launches = dict.fromkeys(LK_ENTRIES, 0)


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

def _normalize_pts(pts, valid):
    """Hartley normalisation over valid points; returns (pts_n, T 3x3)."""
    cnt = torch.clamp(valid.sum(), min=1).to(torch.float32)
    mean = torch.where(valid[:, None], pts, torch.zeros_like(pts)) \
        .sum(0) / cnt
    d = torch.sqrt(torch.sum((pts - mean) ** 2, dim=1))
    mean_d = torch.where(valid, d, torch.zeros_like(d)).sum() / cnt
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-6)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    t_mat = torch.stack([torch.stack([s, zero, -s * mean[0]]),
                         torch.stack([zero, s, -s * mean[1]]),
                         torch.stack([zero, zero, one])])
    return (pts - mean) * s, t_mat


def _dlt_rows(p, q):
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    return r1, r2


def _spd_solve(a, b):
    """Solve a x = b for batched SPD a (Cholesky, no error check)."""
    chol = torch.linalg.cholesky_ex(a)[0]
    return torch.cholesky_solve(b, chol)


def _solve_dlt(a_mat):
    """Least squares A h = 0 under the h22 = 1 gauge, by the normal
    equations (A [..., r, 9])."""
    a8 = a_mat[..., :, :8]
    a9 = a_mat[..., :, 8]
    n_mat = a8.transpose(-1, -2) @ a8 + \
        1e-8 * torch.eye(8, dtype=a_mat.dtype, device=a_mat.device)
    rhs = -(a8 * a9[..., :, None]).sum(-2)
    h8 = _spd_solve(n_mat, rhs[..., None])[..., 0]
    return torch.cat([h8, torch.ones_like(h8[..., :1])], -1)


def _apply_h(h_mat, pts):
    denom = h_mat[..., 2, 0] * pts[..., 0] + h_mat[..., 2, 1] * pts[..., 1] \
        + h_mat[..., 2, 2]
    denom = torch.where(torch.abs(denom) > 1e-9, denom,
                        torch.full_like(denom, 1e-9))
    x = (h_mat[..., 0, 0] * pts[..., 0] + h_mat[..., 0, 1] * pts[..., 1]
         + h_mat[..., 0, 2]) / denom
    y = (h_mat[..., 1, 0] * pts[..., 0] + h_mat[..., 1, 1] * pts[..., 1]
         + h_mat[..., 1, 2]) / denom
    return torch.stack([x, y], -1)


def _sample_idx(valid, u):
    """Hypothesis sample indices: valid points compacted to the front
    (stable), then ``order[int(u * max(cnt, 1)) % n]``."""
    n = valid.shape[-1]
    cnt = torch.clamp(valid.sum(-1), min=1).to(torch.float32)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    cnt = cnt.reshape(cnt.shape + (1,) * (u.dim() - cnt.dim()))
    pick = (u * cnt).to(torch.int32).long() % n
    return torch.gather(order, -1, pick.reshape(order.shape[:-1] + (-1,))) \
        .reshape(u.shape)


def ransac_homography(prev_pts, cur_pts, valid, u, inlier_thresh: int):
    """Fixed-budget RANSAC homography (role of cv2.findHomography): all
    HYP_H 4-point hypotheses (sample draws ``u`` [HYP_H, 4]) are solved and
    scored at once, the best is refined twice by masked DLT over its
    inliers, a refit being kept only if it keeps as many inliers. Returns
    (ok, H 3x3, inlier mask)."""
    cnt = valid.sum()
    p_n, t1 = _normalize_pts(prev_pts, valid)
    q_n, t2 = _normalize_pts(cur_pts, valid)
    samp = _sample_idx(valid, u)                         # [HYP_H, 4]
    r1, r2 = _dlt_rows(p_n[samp], q_n[samp])
    h_cand = _solve_dlt(torch.cat([r1, r2], dim=1)).reshape(-1, 3, 3)
    t2_inv = torch.linalg.inv_ex(t2)[0]
    h_px = t2_inv[None] @ h_cand @ t1[None]
    proj = _apply_h(h_px[:, None], prev_pts[None])
    err2 = torch.sum((proj - cur_pts[None]) ** 2, -1)
    inl = (err2 < RANSAC_REPROJ ** 2) & valid[None, :]
    best = torch.argmax(inl.sum(1))
    inlier = inl[best]
    h_best = h_px[best]
    r1, r2 = _dlt_rows(p_n, q_n)
    for _ in range(2):
        w = inlier[:, None].to(torch.float32)
        h_vec = _solve_dlt(torch.cat([r1 * w, r2 * w], dim=0))
        h_ref = t2_inv @ h_vec.reshape(3, 3) @ t1
        err2 = torch.sum((_apply_h(h_ref[None], prev_pts) - cur_pts) ** 2,
                         -1)
        new_inlier = (err2 < RANSAC_REPROJ ** 2) & valid
        better = new_inlier.sum() >= inlier.sum()
        h_best = torch.where(better, h_ref, h_best)
        inlier = torch.where(better, new_inlier, inlier)
    h22 = h_best[2, 2]
    h_norm = h_best / torch.where(torch.abs(h22) > 1e-9, h22,
                                  torch.full_like(h22, 1e-9))
    ok = (cnt >= 4) & (inlier.sum() >= inlier_thresh)
    return ok, h_norm, inlier


def _sim_matrix(a, b, tx, ty):
    """[..., 2, 3] matrices [[a, -b, tx], [b, a, ty]]."""
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], -2)


def ransac_similarity(prev_pts, cur_pts, valid, u, inlier_thresh: int):
    """Fixed-budget RANSAC similarity fits for a batch of tracks (role of
    cv2.estimateAffinePartial2D): model q = [[a, -b], [b, a]] p + t from
    2-point hypotheses (draws ``u`` [T, HYP_A, 2]), best refined twice by
    masked least squares. prev/cur [T, K, 2], valid [T, K]. Returns (ok,
    A [T, 2, 3], inlier mask, n_matched, n_inliers)."""
    cnt = valid.sum(-1)
    samp = _sample_idx(valid, u)                         # [T, HYP_A, 2]

    def pick(pts, i):
        return torch.gather(pts, 1, samp[..., i:i + 1].expand(-1, -1, 2))

    p1, p2 = pick(prev_pts, 0), pick(prev_pts, 1)
    q1, q2 = pick(cur_pts, 0), pick(cur_pts, 1)
    dp = p2 - p1
    dq = q2 - q1
    denom = torch.clamp(dp[..., 0] ** 2 + dp[..., 1] ** 2, min=1e-9)
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / denom
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / denom
    tx = q1[..., 0] - (a * p1[..., 0] - b * p1[..., 1])
    ty = q1[..., 1] - (b * p1[..., 0] + a * p1[..., 1])

    px, py = prev_pts[..., 0], prev_pts[..., 1]          # [T, K]
    cx, cy = cur_pts[..., 0], cur_pts[..., 1]
    proj_x = a[..., None] * px[:, None] - b[..., None] * py[:, None] \
        + tx[..., None]
    proj_y = b[..., None] * px[:, None] + a[..., None] * py[:, None] \
        + ty[..., None]
    err2 = (proj_x - cx[:, None]) ** 2 + (proj_y - cy[:, None]) ** 2
    inl = (err2 < RANSAC_REPROJ ** 2) & valid[:, None, :]
    best = torch.argmax(inl.sum(-1), dim=1)              # [T]
    t_idx = torch.arange(prev_pts.shape[0], device=prev_pts.device)
    inlier = inl[t_idx, best]
    aff_best = _sim_matrix(a[t_idx, best], b[t_idx, best],
                           tx[t_idx, best], ty[t_idx, best])
    eye4 = 1e-6 * torch.eye(4, device=prev_pts.device)
    for _ in range(2):
        w = inlier.to(torch.float32)
        sw = torch.clamp(w.sum(-1), min=1.0)
        sx = (w * px).sum(-1)
        sy = (w * py).sum(-1)
        sxx = (w * (px * px + py * py)).sum(-1)
        su = (w * cx).sum(-1)
        sv = (w * cy).sum(-1)
        sxu = (w * (px * cx + py * cy)).sum(-1)
        sxv = (w * (px * cy - py * cx)).sum(-1)
        z = torch.zeros_like(sw)
        m = torch.stack([torch.stack([sxx, z, sx, sy], -1),
                         torch.stack([z, sxx, -sy, sx], -1),
                         torch.stack([sx, -sy, sw, z], -1),
                         torch.stack([sy, sx, z, sw], -1)], -2)
        rhs = torch.stack([sxu, sxv, su, sv], -1)[..., None]
        sol = _spd_solve(m + eye4, rhs)[..., 0]
        a_r, b_r, tx_r, ty_r = sol.unbind(-1)
        ex = a_r[:, None] * px - b_r[:, None] * py + tx_r[:, None] - cx
        ey = b_r[:, None] * px + a_r[:, None] * py + ty_r[:, None] - cy
        new_inlier = (ex ** 2 + ey ** 2 < RANSAC_REPROJ ** 2) & valid
        better = new_inlier.sum(-1) >= inlier.sum(-1)
        aff_best = torch.where(better[:, None, None],
                               _sim_matrix(a_r, b_r, tx_r, ty_r), aff_best)
        inlier = torch.where(better[:, None], new_inlier, inlier)
    n_inl = inlier.sum(-1)
    ok = (cnt >= 3) & (n_inl >= inlier_thresh)
    return ok, aff_best, inlier, cnt, n_inl


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """JAX's threefry-2x32 hash (``jax._src.prng``, 20 rounds) of the
    counter pairs ``(x1, x2)`` under the key ``(k1, k2)``, on numpy uint32
    arrays (whose sums wrap as uint32's do), all four broadcast together.
    The rounds update two buffers in place: no array is allocated per
    step, which is most of the host time at 8 streams x 128 tracks."""
    u32 = np.uint32
    ks = (k1, k2, k1 ^ k2 ^ u32(0x1BD11BDA))
    shape = np.broadcast_shapes(*(np.shape(v) for v in (k1, k2, x1, x2)))
    a, b, tmp = (np.empty(shape, u32) for _ in range(3))
    np.add(x1, ks[0], out=a, dtype=u32)
    np.add(x2, ks[1], out=b, dtype=u32)
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            a += b
            np.right_shift(b, u32(32 - r), out=tmp)
            np.left_shift(b, u32(r), out=b)
            b |= tmp
            b ^= a
        a += ks[(i + 1) % 3]
        b += ks[(i + 2) % 3]
        b += u32(i + 1)
    return a, b


def _uniform(k1, k2, n: int):
    """``jax.random.uniform(key, (n,))`` for keys ``[...]``: ``[..., n]``
    float32 in [0, 1), ``jax_threefry_partitionable`` bits."""
    b1, b2 = _threefry2x32(k1[..., None], k2[..., None], np.uint32(0),
                           np.arange(n, dtype=np.uint32))
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def ransac_draws_batch(seeds, f_cap: int, device):
    """Every stream's RANSAC uniforms in one call: ``seeds`` [S] ->
    (u_h [S, HYP_H, 4], u_a [S, f_cap, HYP_A, 2]), the draws of
    ``ransac_draws`` for each seed. Computed on the host, then moved to
    ``device`` once."""
    seed = (np.asarray(seeds, np.int64).reshape(-1) & 0xFFFFFFFF) \
        .astype(np.uint32)
    zero = np.zeros_like(seed)
    # PRNGKey(seed) = (0, seed); fold_in(key, d) = threefry(key, (0, d))
    h1, h2 = _threefry2x32(zero, seed, zero, zero)
    a1, a2 = _threefry2x32(zero, seed, zero, zero + np.uint32(1))
    # split(key, f_cap): threefry(key, (0, t)) for t < f_cap
    s1, s2 = _threefry2x32(a1[:, None], a2[:, None], np.uint32(0),
                           np.arange(f_cap, dtype=np.uint32))
    u_h = _uniform(h1, h2, HYP_H * 4).reshape(-1, HYP_H, 4)
    u_a = _uniform(s1, s2, HYP_A * 2).reshape(-1, f_cap, HYP_A, 2)
    return torch.from_numpy(u_h).to(device), torch.from_numpy(u_a).to(device)


def ransac_draws(seed: int, f_cap: int, device):
    """The frame's RANSAC uniforms: (u_h [HYP_H, 4], u_a [f_cap, HYP_A,
    2]), the JAX package's ``flow_post_core`` draws for the uint32
    ``seed`` bit for bit: ``uniform(fold_in(PRNGKey(seed), 0))`` and, per
    track, ``uniform`` of ``split(fold_in(PRNGKey(seed), 1), f_cap)``."""
    u_h, u_a = ransac_draws_batch([seed], f_cap, device)
    return u_h[0], u_a[0]


# ---------------------------------------------------------------------------
# The flow step: point assembly, LK, estimates
# ---------------------------------------------------------------------------

def _frame_tlbr(spec: FlowSpec, device):
    w_f, h_f = spec.size
    return torch.tensor([0.0, 0.0, w_f - 1.0, h_f - 1.0], device=device)


def flow_points_core(spec: FlowSpec, prev_state, t_tlbrs, t_valid, t_kps,
                     t_kp_valid):
    """Corner management + keypoint/background point assembly (the pre-LK
    half of a flow step). Tracks arrive sorted near-to-far; a point inside
    a nearer track's box is blocked (the parallel form of the reference's
    foreground-mask carving). Returns (all_prev [P, 2], all_valid [P],
    inside [T, 4])."""
    _, _, cand_pts, cand_score, bg_pts, bg_score = prev_state
    dev = t_tlbrs.device
    frame_tlbr = _frame_tlbr(spec, dev)
    t_idx = torch.arange(t_tlbrs.shape[0], device=dev)
    inside = torch.cat([torch.maximum(t_tlbrs[:, 0:2], frame_tlbr[0:2]),
                        torch.minimum(t_tlbrs[:, 2:4], frame_tlbr[2:4])], 1)

    box = in_box(cand_pts[None], inside[:, None]) & t_valid[:, None]
    box_i = box.to(torch.int32)
    free = box & ((torch.cumsum(box_i, 0) - box_i) == 0)
    visible_area = free.sum(1) * (CELL * CELL)

    center = (t_tlbrs[:, 0:2] + t_tlbrs[:, 2:4]) * 0.5
    semi = (t_tlbrs[:, 2:4] - t_tlbrs[:, 0:2] + 1.0) * 0.5
    rel = (cand_pts[None] - center[:, None]) / \
        torch.clamp(semi[:, None], min=1e-6)
    in_ellipse = torch.sum(rel ** 2, -1) <= 1.0
    neg_inf = torch.tensor(-float('inf'), device=dev)
    box_max = torch.max(torch.where(free, cand_score[None], neg_inf), 1).values
    quality_ok = cand_score[None] >= spec.quality_level * \
        torch.clamp(box_max[:, None], min=1e-6)
    cand_masked = torch.where(free & in_ellipse & quality_ok,
                              cand_score[None], neg_inf)
    top_score, top_i = _topk_stable(cand_masked, KP_PER_TRACK)
    new_kps = cand_pts[top_i]
    new_valid = torch.isfinite(top_score)

    kp_in_box = in_box(t_kps, inside[:, None])
    kp_in_other = in_box(t_kps[:, :, None], inside[None, None]) \
        & t_valid[None, None, :]
    nearer = t_idx[None, None, :] < t_idx[:, None, None]
    prop_valid = t_kp_valid & kp_in_box & ~torch.any(kp_in_other & nearer, -1)
    need_detect = prop_valid.sum(1) < spec.feat_density * visible_area
    kps = torch.where(need_detect[:, None, None], new_kps, t_kps)
    kp_valid = torch.where(need_detect[:, None], new_valid, prop_valid) \
        & t_valid[:, None]

    bg_in_track = torch.any(in_box(bg_pts[None], inside[:, None])
                            & t_valid[:, None], 0)
    bg_ok = ~bg_in_track & (bg_score > 0.01 * torch.clamp(bg_score.max(),
                                                          min=1e-6))
    bg_masked = torch.where(bg_ok, bg_score, neg_inf)
    bg_top_score, bg_top_i = _topk_stable(bg_masked,
                                          min(BG_KP, bg_masked.shape[0]))
    all_prev = torch.cat([kps.reshape(-1, 2), bg_pts[bg_top_i]], 0)
    all_valid = torch.cat([kp_valid.reshape(-1),
                           torch.isfinite(bg_top_score)], 0)
    return all_prev, all_valid, inside


def lk_core(spec: FlowSpec, prev_u8, cur_u8, all_prev, all_valid):
    """One batched pyramidal-LK solve for all points (full-res coords); with
    a leading stream axis, one solve for every stream's points."""
    profiler.count('host_syncs')        # the constant's blocking upload
    opt_scale = torch.tensor(spec.opt_scale, dtype=torch.float32,
                             device=all_prev.device)
    cur_scaled, status, err = lk_pyramidal(prev_u8, cur_u8,
                                           all_prev * opt_scale, all_valid,
                                           spec)
    return cur_scaled / opt_scale, status & all_valid & (err < spec.max_error)


def flow_post_core(spec: FlowSpec, t_tlbrs, t_valid, inside, all_prev,
                   all_cur, status, u_h, u_a):
    """Camera homography from the background matches, per-track
    similarity fits and box estimates (the post-LK half of a flow step)."""
    dev = t_tlbrs.device
    frame_tlbr = _frame_tlbr(spec, dev)
    f_cap = t_tlbrs.shape[0]
    t_idx = torch.arange(f_cap, device=dev)
    n_trk = f_cap * KP_PER_TRACK
    trk_prev = all_prev[:n_trk].reshape(f_cap, KP_PER_TRACK, 2)
    trk_cur = all_cur[:n_trk].reshape(f_cap, KP_PER_TRACK, 2)
    trk_status = status[:n_trk].reshape(f_cap, KP_PER_TRACK)
    bg_prev, bg_cur, bg_status = all_prev[n_trk:], all_cur[n_trk:], \
        status[n_trk:]

    h_ok, h_mat, bg_inlier = ransac_homography(bg_prev, bg_cur, bg_status,
                                               u_h, spec.inlier_thresh)

    cur_in_frame = in_box(trk_cur, frame_tlbr[None, None])
    cur_in_other = in_box(trk_cur[:, :, None], inside[None, None]) \
        & t_valid[None, None, :]
    nearer = t_idx[None, None, :] < t_idx[:, None, None]
    match_valid = trk_status & cur_in_frame & \
        ~torch.any(cur_in_other & nearer, -1)
    sim_ok, aff, sim_inlier, n_matched, n_inl = ransac_similarity(
        trk_prev, trk_cur, match_valid, u_a, spec.inlier_thresh)

    a_col = aff[:, :, 0]
    scale = torch.sqrt(torch.sum(a_col * a_col, 1))
    scale = torch.where((scale < 0.9) | (scale > 1.1),
                        torch.ones_like(scale), scale)
    tl_new = torch.einsum('tij,tj->ti', aff[:, :, 0:2], t_tlbrs[:, 0:2]) \
        + aff[:, :, 2]
    wh = (t_tlbrs[:, 2:4] - t_tlbrs[:, 0:2] + 1.0) * scale[:, None]
    est = torch.round(torch.cat([tl_new, tl_new + wh - 1.0], 1))
    est_in_frame = \
        (torch.minimum(est[:, 2], frame_tlbr[2])
         >= torch.maximum(est[:, 0], frame_tlbr[0])) & \
        (torch.minimum(est[:, 3], frame_tlbr[3])
         >= torch.maximum(est[:, 1], frame_tlbr[1]))
    est_valid = t_valid & sim_ok & est_in_frame & \
        (n_inl >= spec.inlier_thresh)
    inlier_ratio = n_inl / torch.clamp(n_matched, min=1)
    return (h_ok, h_mat, bg_prev, bg_cur, bg_inlier & bg_status, est,
            est_valid, inlier_ratio.to(torch.float32), trk_prev, trk_cur,
            sim_inlier & match_valid)


def flow_step_core(spec: FlowSpec, prev_state, cur_state, t_tlbrs, t_valid,
                   t_kps, t_kp_valid, draws):
    """One flow step over two preprocessed frame states: corner
    management, one batched LK solve, camera homography RANSAC, per-track
    similarity fits (``flow_points_core``, ``lk_core``,
    ``flow_post_core``); ``draws`` are the RANSAC uniforms ``(u_h,
    u_a)``."""
    all_prev, all_valid, inside = flow_points_core(
        spec, prev_state, t_tlbrs, t_valid, t_kps, t_kp_valid)
    all_cur, status = lk_core(spec, prev_state[1], cur_state[1], all_prev,
                              all_valid)
    return flow_post_core(spec, t_tlbrs, t_valid, inside, all_prev, all_cur,
                          status, *draws)


def flow_step(spec: FlowSpec, prev_state, cur_state, t_tlbrs, t_valid,
              t_kps, t_kp_valid, seed: int):
    """``flow_step_core`` on host arrays, with the draws of ``seed``."""
    dev = cur_state[2].device
    args = (torch.as_tensor(a, device=dev)
            for a in (t_tlbrs, t_valid, t_kps, t_kp_valid))
    return flow_step_core(spec, prev_state, cur_state, *args,
                          ransac_draws(seed, len(t_tlbrs), dev))
