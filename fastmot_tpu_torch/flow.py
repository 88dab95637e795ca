"""KLT optical-flow state with camera-motion estimation (port of
``fastmot_tpu/flow.py``).

``Flow`` holds the configuration (``FlowSpec``), the previous frame's
preprocessed state on the device and the RANSAC seed; the tracker runs
the per-frame flow step (``ops/flow_kernels.py``) itself. ``predict`` is
the JAX package's legacy per-track entry point: one ``flow_step`` over
the given tracks, read back to the host.
"""
from __future__ import annotations

from types import SimpleNamespace

import logging

import numpy as np
import torch

from .device import torch_device
from .ops import flow_kernels as fk

LOGGER = logging.getLogger(__name__)

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

    def next_seed(self) -> int:
        return self.seed

    def predict(self, frame, tracks):
        """Predict tracklet positions and camera motion. Returns
        ``({trk_id: tlbr}, homography)``, or ``({}, None)`` when camera
        motion cannot be estimated. Updates the tracks' keypoints."""
        frame = torch.as_tensor(frame, device=self.device)
        if self.device_state is None:
            self.init(frame)
            return {}, None
        cur_state = fk.preprocess(self.spec, frame)
        # closest to farthest
        tracks = sorted(tracks, reverse=True)[:fk.MAX_FLOW_TRACKS]
        f_cap = fk.flow_budget(len(tracks))
        t_tlbrs = np.zeros((f_cap, 4), np.float32)
        t_valid = np.zeros(f_cap, bool)
        t_kps = np.zeros((f_cap, fk.KP_PER_TRACK, 2), np.float32)
        t_kp_valid = np.zeros((f_cap, fk.KP_PER_TRACK), bool)
        for i, trk in enumerate(tracks):
            t_tlbrs[i] = trk.tlbr
            t_valid[i] = True
            k = min(len(trk.keypoints), fk.KP_PER_TRACK)
            if k:
                t_kps[i, :k] = trk.keypoints[:k]
                t_kp_valid[i, :k] = True
        out = fk.flow_step(self.spec, self.device_state, cur_state, t_tlbrs,
                           t_valid, t_kps, t_kp_valid, self.seed)
        self.advance(cur_state)
        (homog_ok, h_mat, bg_prev, bg_cur, bg_inlier, est_tlbrs, est_valid,
         inlier_ratio, out_prev_kps, out_kps, out_kp_valid) = \
            (t.cpu().numpy() for t in out)
        if not bool(homog_ok):
            self.bg_keypoints = np.empty((0, 2), np.float32)
            for trk in tracks:
                trk.keypoints = np.empty((0, 2), np.float32)
            LOGGER.warning('Camera motion estimation failed')
            return {}, None
        keep = bg_inlier.astype(bool)
        self.prev_bg_keypoints = bg_prev[keep]
        self.bg_keypoints = bg_cur[keep]
        next_bboxes = {}
        for i, trk in enumerate(tracks):
            kv = out_kp_valid[i].astype(bool)
            trk.prev_keypoints = out_prev_kps[i][kv]
            trk.keypoints = out_kps[i][kv]
            if est_valid[i]:
                next_bboxes[trk.trk_id] = est_tlbrs[i].astype(np.float64)
                trk.inlier_ratio = float(inlier_ratio[i])
            else:
                trk.keypoints = np.empty((0, 2), np.float32)
        return next_bboxes, h_mat.astype(np.float64)
