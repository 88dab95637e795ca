"""The one traffic generator: camera frames and the objects in them, from a
traffic file's parameters and a seed.

Frames. Each stream gets its own texture (uniform noise blurred with a
Gaussian of sigma 1.5, as the JAX package's ``bench.py`` draws it), and
each frame is a window onto it that drifts smoothly, with a period of
``frame_period`` frames. They are made on the device and handed over as
host uint8 arrays [period, S, H, W, 3], as a video decoder would.

Objects. Each stream has ``objects`` objects whose box centres follow
smooth periodic paths (a sine on each axis, with periods that divide
``det_period`` frames, so the paths close without a jump). A share
``leave_share`` of them swing past an edge of the frame, so they leave and
come back through it. A box counts as detected where at least half of it
lies inside the frame and a draw at ``miss_rate`` does not drop it; each
detected box is jittered by a Gaussian of ``jitter_px`` on each side.
Detections exist for the association frames (every ``skip``-th) of one
``det_period``; frame ``f`` reads set ``(f // skip) % n_sets``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

MAX_DETS = 128       # the tracker's detection capacity


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A closed loop over recorded files: every stream's next frame as
    soon as the program takes it, tracks read back once a skip cycle."""
    streams: int
    objects: int
    frame_size: tuple = (1280, 720)
    frame_period: int = 40
    drift_px: int = 16
    det_period: int = 1200
    path_periods: tuple = (300, 400, 600)
    box_width_px: tuple = (40, 90)
    box_aspect: tuple = (2.0, 3.0)
    max_swing_px: float = 250.0   # a path that stays in view swings less
    centres: tuple = (0.5, 0.3)   # the middle share of the frame (x, y)
                                  # that paths centre in
    leave_share: float = 0.0
    miss_rate: float = 0.0
    jitter_px: float = 0.0
    conf: tuple = (0.3, 0.99)

    @classmethod
    def load(cls, path):
        data = json.loads(Path(path).read_text())
        data.pop('why', None)
        for k in ('frame_size', 'path_periods', 'box_width_px',
                  'box_aspect', 'conf', 'centres'):
            if k in data:
                data[k] = tuple(data[k])
        t = cls(**data)
        if not 0 < t.objects <= MAX_DETS:
            raise ValueError(f'{path}: {t.objects} objects, the tracker '
                             f'holds {MAX_DETS} detections')
        if any(t.det_period % p for p in t.path_periods):
            raise ValueError(f'{path}: path periods must divide '
                             f'det_period {t.det_period}')
        return t


def _generator(seed: int, salt: int, device) -> torch.Generator:
    # the seed may exceed 63 bits' signed range; fold it with a salt
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))
    return g


def _blur(x, sigma=1.5):
    """Separable Gaussian blur of [N, C, H, W] with a 4-sigma radius,
    edges reflected (scipy's ``gaussian_filter`` default mode)."""
    r = int(4 * sigma + 0.5)
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    c = x.shape[1]
    x = torch.nn.functional.pad(x, (r, r, r, r), mode='reflect')
    x = torch.nn.functional.conv2d(x, k.reshape(1, 1, 1, -1).repeat(
        c, 1, 1, 1), groups=c)
    return torch.nn.functional.conv2d(x, k.reshape(1, 1, -1, 1).repeat(
        c, 1, 1, 1), groups=c)


def drift(i: int, pad: int, period: int):
    """The window's offset (dx, dy) in frame ``i`` of the period."""
    ph = 2 * math.pi * (i % period) / period
    return (int(pad / 2 + pad / 2 * math.sin(ph)),
            int(pad / 2 + pad / 2 * math.cos(2 * ph)))


def make_frames(t: Traffic, seed: int, device) -> np.ndarray:
    """[frame_period, S, H, W, 3] uint8 BGR frames on the host."""
    w, h = t.frame_size
    pad = t.drift_px
    g = _generator(seed, 1, device)
    out = np.empty((t.frame_period, t.streams, h, w, 3), np.uint8)
    for s in range(t.streams):
        base = torch.rand((1, 3, h + 2 * pad, w + 2 * pad), generator=g,
                          device=device) * 255.0
        base = _blur(base)[0].permute(1, 2, 0)
        base = torch.clamp(base, 0, 255).to(torch.uint8)
        views = torch.stack([
            base[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            for dx, dy in (drift(i, pad, t.frame_period)
                           for i in range(t.frame_period))])
        out[:, s] = views.cpu().numpy()
    return out


def object_paths(t: Traffic, seed: int, device):
    """Each object's path and box: a dict of [S, N] tensors (centre,
    amplitude and phase on both axes, periods in frames, box width and
    height)."""
    g = _generator(seed, 2, device)
    s, n = t.streams, t.objects
    w, h = t.frame_size

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((s, n), generator=g,
                                           device=device)
    bw = u(*t.box_width_px)
    bh = bw * u(*t.box_aspect)
    periods = torch.tensor(t.path_periods, dtype=torch.float32,
                           device=device)
    tx = periods[torch.randint(len(periods), (s, n), generator=g,
                               device=device)]
    ty = periods[torch.randint(len(periods), (s, n), generator=g,
                               device=device)]
    # a path stays inside the frame with a margin of half a box and swings
    # at most max_swing_px; one that leaves starts near a side edge and
    # swings a box past it: both stay under about 6 px a frame
    leaves = u() < t.leave_share
    cx = u((0.5 - t.centres[0] / 2) * w, (0.5 + t.centres[0] / 2) * w)
    cy = u((0.5 - t.centres[1] / 2) * h, (0.5 + t.centres[1] / 2) * h)
    ax_in = torch.clamp(torch.minimum(cx - bw / 2, w - cx - bw / 2),
                        max=t.max_swing_px) * u(0.3, 1.0)
    ay = torch.clamp(torch.minimum(cy - bh / 2, h - cy - bh / 2), min=0.0,
                     max=t.max_swing_px / 2) * u(0.2, 0.8)
    near = u(0.1 * w, 0.2 * w)
    right = u() < 0.5
    cx = torch.where(leaves, torch.where(right, w - near, near), cx)
    ax = torch.where(leaves, near + bw, ax_in)
    return dict(cx=cx, cy=cy, ax=ax, ay=ay, tx=tx, ty=ty,
                px=u(0, 2 * math.pi), py=u(0, 2 * math.pi), bw=bw, bh=bh,
                leaves=leaves)


def boxes_at(paths, frames: torch.Tensor):
    """Boxes [F, S, N, 4] (tlbr) of every object at the frame indices
    ``frames`` [F], before clipping, misses and jitter."""
    f = frames.float()[:, None, None]
    x = paths['cx'] + paths['ax'] * torch.sin(
        2 * math.pi * f / paths['tx'] + paths['px'])
    y = paths['cy'] + paths['ay'] * torch.sin(
        2 * math.pi * f / paths['ty'] + paths['py'])
    hw, hh = paths['bw'] / 2, paths['bh'] / 2
    return torch.stack([x - hw, y - hh, x + hw, y + hh], -1)


def make_detections(t: Traffic, seed: int, skip: int, label: int, device):
    """The association frames' detections of one ``det_period``: tlbr [F,
    S, 128, 4] float32, label [F, S, 128] int32, conf, valid, the detected
    ones first in each set."""
    if t.det_period % skip:
        raise ValueError(f'skip {skip} does not divide det_period')
    paths = object_paths(t, seed, device)
    frames = torch.arange(0, t.det_period, skip, device=device)
    raw = boxes_at(paths, frames)
    w, h = t.frame_size
    clipped = torch.stack([raw[..., 0].clamp(0, w - 1),
                           raw[..., 1].clamp(0, h - 1),
                           raw[..., 2].clamp(0, w - 1),
                           raw[..., 3].clamp(0, h - 1)], -1)

    def area(b):
        return (b[..., 2] - b[..., 0]).clamp(min=0) * \
            (b[..., 3] - b[..., 1]).clamp(min=0)
    inside = area(clipped) >= 0.5 * area(raw)
    g = _generator(seed, 3, device)
    shape = inside.shape
    missed = torch.rand(shape, generator=g, device=device) < t.miss_rate
    jitter = torch.randn(shape + (4,), generator=g, device=device) \
        * t.jitter_px
    conf = t.conf[0] + (t.conf[1] - t.conf[0]) * torch.rand(
        shape, generator=g, device=device)
    valid = inside & ~missed
    boxes = clipped + jitter
    # the detected boxes first, in object order
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    n_f, n_s, n = shape
    tlbr = torch.zeros((n_f, n_s, MAX_DETS, 4), device=device)
    tlbr[:, :, :n] = torch.take_along_dim(boxes, order[..., None], -2)
    val = torch.zeros((n_f, n_s, MAX_DETS), dtype=torch.bool, device=device)
    val[:, :, :n] = torch.take_along_dim(valid, order, -1)
    cf = torch.zeros((n_f, n_s, MAX_DETS), device=device)
    cf[:, :, :n] = torch.take_along_dim(conf, order, -1)
    tlbr = torch.where(val[..., None], tlbr, torch.zeros_like(tlbr))
    cf = torch.where(val, cf, torch.zeros_like(cf))
    lab = torch.where(val, torch.full_like(val, label, dtype=torch.int32),
                      torch.full_like(val, -1, dtype=torch.int32))
    return tlbr, lab, cf, val
