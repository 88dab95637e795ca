"""Torch ops of the port (geometry, distances, assignment, flow, the OSNet
block kernel). Each mirrors the module of the same name in
``fastmot_tpu/ops``; the package exports the JAX package's names."""

from .geometry import (  # noqa: F401
    area, as_tlbr, aspect_ratio, bbox_ious, diou_nms_mask, enclosing,
    find_occluded, get_center, get_size, intersection, iom, ios, ios_matrix,
    nms_mask, to_tlbr, to_tlwh,
)
from .distance import (  # noqa: F401
    INF_DIST, Metric, cdist, cosine_dist, diou_dist, euclidean_dist,
    giou_dist, iou_dist,
)
from .assignment import (  # noqa: F401
    CHI_SQ_INV_95, INF_COST, auction_lap, fuse_motion, gate_cost,
    greedy_match_arrays,
)
