"""KLT optical-flow state with camera-motion estimation (port of
``fastmot_tpu/flow.py``).

``Flow`` holds the configuration (``FlowSpec``), the previous frame's
preprocessed state on the device and the RANSAC seed; the tracker runs
the per-frame flow step (``ops/flow_kernels.py``) itself. The legacy
``predict`` entry point of the JAX package is not ported.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .device import torch_device
from .ops import flow_kernels as fk


def _params_dict(p, defaults):
    out = dict(defaults)
    if p is not None:
        out.update(vars(p) if isinstance(p, SimpleNamespace) else dict(p))
    return out


class Flow:
    """KLT tracker over a fixed per-frame point budget: at most
    ``fk.MAX_FLOW_TRACKS`` tracks of ``fk.KP_PER_TRACK`` keypoints each,
    plus ``fk.BG_KP`` background points."""

    def __init__(self, size,
                 bg_feat_scale_factor=(0.1, 0.1),
                 opt_flow_scale_factor=(0.5, 0.5),
                 feat_density=0.005,
                 feat_dist_factor=0.06,
                 ransac_max_iter=500,
                 ransac_conf=0.99,
                 max_error=100,
                 inlier_thresh=4,
                 bg_feat_thresh=10,
                 obj_feat_params=None,
                 opt_flow_params=None,
                 device='cuda'):
        self.size = tuple(int(s) for s in size)
        self.device = torch_device(device)
        assert 0 < bg_feat_scale_factor[0] <= 1 and \
            0 < bg_feat_scale_factor[1] <= 1
        assert 0 < opt_flow_scale_factor[0] <= 1 and \
            0 < opt_flow_scale_factor[1] <= 1
        assert 0 <= feat_density <= 1
        assert feat_dist_factor >= 0
        assert ransac_max_iter >= 0
        assert 0 <= ransac_conf <= 1
        assert 0 <= max_error <= 255
        assert inlier_thresh >= 1
        assert bg_feat_thresh >= 0
        obj = _params_dict(obj_feat_params, {
            'maxCorners': 1000, 'qualityLevel': 0.06, 'blockSize': 3})
        opt = _params_dict(opt_flow_params, {
            'winSize': (5, 5), 'maxLevel': 5, 'criteria': (3, 10, 0.03)})
        self.spec = fk.FlowSpec(
            size=self.size,
            opt_scale=tuple(opt_flow_scale_factor),
            bg_scale=tuple(bg_feat_scale_factor),
            win=int(opt['winSize'][0]),
            max_level=int(opt['maxLevel']),
            iters=int(opt['criteria'][1]),
            quality_level=float(obj['qualityLevel']),
            max_error=float(max_error),
            feat_density=float(feat_density),
            feat_dist_factor=float(feat_dist_factor),
            ransac_iters=int(ransac_max_iter),
            inlier_thresh=int(inlier_thresh),
        )
        # background keypoints for visualization
        self.bg_keypoints = np.empty((0, 2), np.float32)
        self.prev_bg_keypoints = np.empty((0, 2), np.float32)
        self.device_state = None
        self.seed = 0

    def init(self, frame: torch.Tensor):
        """Preprocess the first frame."""
        self.device_state = fk.preprocess(self.spec, frame)
        self.bg_keypoints = np.empty((0, 2), np.float32)
        self.prev_bg_keypoints = np.empty((0, 2), np.float32)
        self.seed = 0

    def advance(self, cur_state):
        """Adopt the current frame's state after a flow step."""
        self.device_state = cur_state
        self.seed += 1
