"""Box geometry on tlbr tensors (``fastmot_tpu_torch/ops/geometry.py``).

Frozen copy of the plain (CPU) version in the port at the commit
that added the benchmark, with the kernel dispatch taken out; it
imports nothing of the port, so later changes to the port cannot
move the yardstick.
"""
from __future__ import annotations

import torch


def as_tlbr(tlbr: torch.Tensor) -> torch.Tensor:
    """Round a box (or batch of boxes) to integral corners, half-to-even."""
    return torch.round(tlbr)


def get_size(tlbr: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` (w, h) with the +1 inclusive convention."""
    return tlbr[..., 2:4] - tlbr[..., 0:2] + 1.0


def get_width_height(tlbr: torch.Tensor):
    size = get_size(tlbr)
    return size[..., 0], size[..., 1]


def aspect_ratio(tlbr: torch.Tensor) -> torch.Tensor:
    """h / w, or 0 where w <= 0."""
    w, h = get_width_height(tlbr)
    pos = w > 0
    return torch.where(pos, h / torch.where(pos, w, torch.ones_like(w)),
                       torch.zeros_like(w))


def area(tlbr: torch.Tensor) -> torch.Tensor:
    """Box area; 0 for degenerate boxes."""
    w, h = get_width_height(tlbr)
    return torch.where((w > 0) & (h > 0), w * h, torch.zeros_like(w))


def get_center(tlbr: torch.Tensor) -> torch.Tensor:
    return (tlbr[..., 0:2] + tlbr[..., 2:4]) * 0.5


def to_tlwh(tlbr: torch.Tensor) -> torch.Tensor:
    return torch.cat([tlbr[..., 0:2], get_size(tlbr)], dim=-1)


def to_tlbr(tlwh: torch.Tensor) -> torch.Tensor:
    tl = tlwh[..., 0:2]
    br = tl + tlwh[..., 2:4] - 1.0
    return torch.round(torch.cat([tl, br], dim=-1))


def intersection(tlbr1: torch.Tensor, tlbr2: torch.Tensor):
    """Elementwise box intersection: ``(box, valid)``, ``valid`` False
    where the boxes are disjoint."""
    tl = torch.maximum(tlbr1[..., 0:2], tlbr2[..., 0:2])
    br = torch.minimum(tlbr1[..., 2:4], tlbr2[..., 2:4])
    return torch.cat([tl, br], dim=-1), torch.all(br >= tl, dim=-1)


def enclosing(tlbr1: torch.Tensor, tlbr2: torch.Tensor) -> torch.Tensor:
    tl = torch.minimum(tlbr1[..., 0:2], tlbr2[..., 0:2])
    br = torch.maximum(tlbr1[..., 2:4], tlbr2[..., 2:4])
    return torch.cat([tl, br], dim=-1)


def _inter_area(tlbr1: torch.Tensor, tlbr2: torch.Tensor) -> torch.Tensor:
    """Broadcast intersection area with the +1 convention (0 if disjoint)."""
    tl = torch.maximum(tlbr1[..., 0:2], tlbr2[..., 0:2])
    br = torch.minimum(tlbr1[..., 2:4], tlbr2[..., 2:4])
    wh = br - tl + 1.0
    return torch.where(torch.all(wh > 0, dim=-1), wh[..., 0] * wh[..., 1],
                       torch.zeros_like(wh[..., 0]))


def _safe_div(num, den):
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def ios(tlbr1: torch.Tensor, tlbr2: torch.Tensor) -> torch.Tensor:
    """Elementwise intersection-over-self."""
    return _safe_div(_inter_area(tlbr1, tlbr2), area(tlbr1))


def iom(tlbr1: torch.Tensor, tlbr2: torch.Tensor) -> torch.Tensor:
    """Elementwise intersection over the smaller box's area."""
    return _safe_div(_inter_area(tlbr1, tlbr2),
                     torch.minimum(area(tlbr1), area(tlbr2)))


def bbox_ious(tlbrs1: torch.Tensor, tlbrs2: torch.Tensor) -> torch.Tensor:
    """Pairwise [..., N, M] IoU matrix."""
    inter = _inter_area(tlbrs1[..., :, None, :], tlbrs2[..., None, :, :])
    union = area(tlbrs1)[..., :, None] + area(tlbrs2)[..., None, :] - inter
    pos = inter > 0
    return torch.where(
        pos, inter / torch.where(union > 0, union, torch.ones_like(union)),
        torch.zeros_like(inter))


def ios_matrix(tlbrs1: torch.Tensor, tlbrs2: torch.Tensor) -> torch.Tensor:
    """Pairwise [..., N, M] intersection over the row box's area."""
    inter = _inter_area(tlbrs1[..., :, None, :], tlbrs2[..., None, :, :])
    a_self = area(tlbrs1)[..., :, None].expand_as(inter)
    return _safe_div(inter, a_self)


def iom_matrix(tlbrs: torch.Tensor) -> torch.Tensor:
    """Pairwise [..., N, N] intersection over the smaller box's area."""
    inter = _inter_area(tlbrs[..., :, None, :], tlbrs[..., None, :, :])
    a = area(tlbrs)
    return _safe_div(inter, torch.minimum(a[..., :, None], a[..., None, :]))


def find_occluded(tlbrs: torch.Tensor, occlusion_thresh: float,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mask of boxes covered by any other box at IoS >= thresh; ``valid``
    masks out padded rows (they neither occlude nor count as occluded)."""
    n = tlbrs.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=tlbrs.device)
    covered = (ios_matrix(tlbrs, tlbrs) >= occlusion_thresh) & ~eye
    if valid is not None:
        covered = covered & valid[None, :]
        return torch.any(covered, dim=1) & valid
    return torch.any(covered, dim=1)


def diou_matrix(tlbrs: torch.Tensor, beta: float) -> torch.Tensor:
    """Pairwise [..., N, N] DIoU used by the detector's NMS."""
    iou = bbox_ious(tlbrs, tlbrs)
    centers = get_center(tlbrs)
    d = torch.sum((centers[..., :, None, :] - centers[..., None, :, :]) ** 2,
                  dim=-1)
    encl = enclosing(tlbrs[..., :, None, :], tlbrs[..., None, :, :])
    ew, eh = get_width_height(encl)
    c = ew * ew + eh * eh
    return iou - (d / torch.clamp(c, min=1e-12)) ** beta


def greedy_suppress_reference(overlap: torch.Tensor, scores: torch.Tensor,
                              valid: torch.Tensor,
                              thresh: float) -> torch.Tensor:
    """The plain version of ``greedy_suppress``, wave-parallel like the JAX
    version (each wave keeps every remaining box with no remaining
    dominating neighbour, then suppresses the kept boxes' neighbours),
    which equals the sequential greedy scan. The loop runs on the host, one
    sync per wave; a problem with nothing remaining has empty waves."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device)
    over = (overlap > thresh) & (idx[:, None] != idx[None, :])
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    dom = (s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :]))
    sup_dom = over & dom
    keep = torch.zeros_like(valid)
    remaining = valid.clone()
    while bool(remaining.any()):
        dominated = torch.any(sup_dom & remaining[..., :, None], dim=-2)
        wave = remaining & ~dominated
        suppressed = torch.any(over & wave[..., :, None], dim=-2)
        keep = keep | wave
        remaining = remaining & ~wave & ~suppressed
    return keep


greedy_suppress = greedy_suppress_reference
