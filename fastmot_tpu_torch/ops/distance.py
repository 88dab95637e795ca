"""Pairwise distances on torch tensors (port of
``fastmot_tpu/ops/distance.py``): euclidean and cosine through one
``[N, D] x [D, M]`` product in float32, masked with the reference's
``empty_mask``/``fill_val`` semantics, and the box distances."""
from __future__ import annotations

import enum

import torch

from .geometry import (area, bbox_ious, enclosing, get_center,
                       get_width_height)

INF_DIST = 1e5


class Metric(enum.Enum):
    EUCLIDEAN = 0
    COSINE = 1


def euclidean_dist(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """[N, M] euclidean distances via the |a|^2 + |b|^2 - 2ab expansion."""
    a2 = torch.sum(xa * xa, dim=-1)[:, None]
    b2 = torch.sum(xb * xb, dim=-1)[None, :]
    ab = xa @ xb.T
    return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))


def cosine_dist(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """[N, M] cosine distances: 1 - a.b / (|a||b|)."""
    ab = xa @ xb.T
    denom = torch.linalg.norm(xa, dim=-1)[:, None] * \
        torch.linalg.norm(xb, dim=-1)[None, :]
    return 1.0 - ab / torch.where(denom > 0, denom, torch.ones_like(denom))


def cdist(xa: torch.Tensor, xb: torch.Tensor, metric: Metric,
          empty_mask: torch.Tensor | None = None,
          fill_val: float = 1.0) -> torch.Tensor:
    """Masked pairwise distance: ``empty_mask[i, j]`` True replaces the
    entry by ``fill_val``."""
    if metric == Metric.EUCLIDEAN:
        y = euclidean_dist(xa, xb)
    elif metric == Metric.COSINE:
        y = cosine_dist(xa, xb)
    else:
        raise ValueError('Unsupported distance metric')
    if empty_mask is not None:
        y = torch.where(empty_mask, torch.full_like(y, fill_val), y)
    return y


def iou_dist(tlbrs1: torch.Tensor, tlbrs2: torch.Tensor) -> torch.Tensor:
    """1 - IoU pairwise matrix."""
    return 1.0 - bbox_ious(tlbrs1, tlbrs2)


def _pairwise_enclosing_wh(tlbrs1, tlbrs2):
    return get_width_height(enclosing(tlbrs1[:, None, :], tlbrs2[None, :, :]))


def giou_dist(tlbrs1: torch.Tensor, tlbrs2: torch.Tensor) -> torch.Tensor:
    """(1 - GIoU) / 2 pairwise matrix."""
    iou = bbox_ious(tlbrs1, tlbrs2)
    tl = torch.maximum(tlbrs1[:, None, 0:2], tlbrs2[None, :, 0:2])
    br = torch.minimum(tlbrs1[:, None, 2:4], tlbrs2[None, :, 2:4])
    wh = br - tl + 1.0
    inter = torch.where(torch.all(wh > 0, dim=-1), wh[..., 0] * wh[..., 1],
                        torch.zeros_like(wh[..., 0]))
    union = area(tlbrs1)[:, None] + area(tlbrs2)[None, :] - inter
    ew, eh = _pairwise_enclosing_wh(tlbrs1, tlbrs2)
    area_encl = ew * eh
    giou = iou - (area_encl - union) / torch.clamp(area_encl, min=1e-12)
    return (1.0 - giou) * 0.5


def diou_dist(tlbrs1: torch.Tensor, tlbrs2: torch.Tensor) -> torch.Tensor:
    """(1 - DIoU) / 2 pairwise matrix with beta = 0.6."""
    iou = bbox_ious(tlbrs1, tlbrs2)
    d = torch.sum((get_center(tlbrs1)[:, None, :]
                   - get_center(tlbrs2)[None, :, :]) ** 2, dim=-1)
    ew, eh = _pairwise_enclosing_wh(tlbrs1, tlbrs2)
    c = ew * ew + eh * eh
    diou = iou - (d / torch.clamp(c, min=1e-12)) ** 0.6
    return (1.0 - diou) * 0.5
