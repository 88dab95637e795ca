"""The tracker's two frame kinds over a stream axis, from the plain cores.

``gap_step`` is a gap frame for every stream (preprocess, point assembly,
pyramidal LK, RANSAC and the Kalman commit) and ``assoc_step`` the
association after it (costs, the cascade's auction stages, the greedy
finals, the commit), as ``fastmot_tpu_torch/parallel/stream_tracker.py``
sequences them. ``TrackerParams`` works out, from the configuration alone,
the constants the tracker derives from it (the Kalman matrices of the
frame interval, the flow spec, the association's gates).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from . import flow as fk
from . import kalman as kf
from . import tracker as trk
from .distance import Metric


@dataclasses.dataclass
class TrackerParams:
    kf_cfg: kf.KalmanConfig
    spec: fk.FlowSpec
    metric: Metric
    max_age: int
    age_penalty: float
    motion_weight: float
    max_assoc_cost: float
    max_reid_cost: float
    iou_thresh: float
    duplicate_thresh: float
    occlusion_thresh: float
    conf_thresh: float
    confirm_hits: int
    history_size: int
    assoc_eps: float
    trans: torch.Tensor
    acc_cov: torch.Tensor
    frame_tlbr: torch.Tensor

    @classmethod
    def from_config(cls, size, tracker_cfg, metric, dt, device='cpu'):
        """``tracker_cfg``: the configuration's ``tracker_cfg``; ``size``
        the frame (W, H); ``dt`` the frame interval."""
        cfg = dict(tracker_cfg)
        kcfg = kf.KalmanConfig(**cfg.pop('kalman_filter_cfg', {}) or {})
        flow = dict(cfg.pop('flow_cfg', {}) or {})
        obj = {'qualityLevel': 0.06, **flow.get('obj_feat_params', {})}
        opt = {'winSize': (5, 5), 'maxLevel': 5, 'criteria': (3, 10, 0.03),
               **flow.get('opt_flow_params', {})}
        spec = fk.FlowSpec(
            size=tuple(int(s) for s in size),
            opt_scale=tuple(flow.get('opt_flow_scale_factor', (0.5, 0.5))),
            bg_scale=tuple(flow.get('bg_feat_scale_factor', (0.1, 0.1))),
            win=int(opt['winSize'][0]), max_level=int(opt['maxLevel']),
            iters=int(opt['criteria'][1]),
            quality_level=float(obj['qualityLevel']),
            max_error=float(flow.get('max_error', 100)),
            feat_density=float(flow.get('feat_density', 0.005)),
            feat_dist_factor=float(flow.get('feat_dist_factor', 0.06)),
            ransac_iters=int(flow.get('ransac_max_iter', 500)),
            inlier_thresh=int(flow.get('inlier_thresh', 4)))
        acc_cov, _, trans = (torch.as_tensor(a, device=device)
                             for a in kf.init_mats(kcfg, dt))
        defaults = dict(max_age=6, age_penalty=2, motion_weight=0.2,
                        max_assoc_cost=0.9, max_reid_cost=0.45,
                        iou_thresh=0.4, duplicate_thresh=0.8,
                        occlusion_thresh=0.7, conf_thresh=0.5,
                        confirm_hits=1, history_size=50, assoc_eps=1e-2)
        defaults.update(cfg)
        rect = torch.tensor([0, 0, size[0] - 1, size[1] - 1],
                            dtype=torch.float32, device=device)
        return cls(kcfg, spec, Metric[str(metric).upper()], trans=trans,
                   acc_cov=acc_cov, frame_tlbr=rect, **defaults)


def preprocess(params, frames_u8):
    """The flow state of [S, H, W, 3] uint8 frames."""
    return fk.preprocess_reference(params.spec, frames_u8)


def gap_step(params, state, prev_pre, cur_pre, seeds):
    """One gap frame of every stream: ``state`` the [S, ...] state tuple
    before it, ``prev_pre``/``cur_pre`` the two frames' flow states,
    ``seeds`` each stream's RANSAC seed. Returns the new state."""
    active = state[3] & (state[4] < 2)
    f_cap = fk.flow_budget(int(active.sum(1).max()))
    spec = params.spec
    all_prev, all_valid, inside, forder, f_tlbrs, f_valid = vmap(
        lambda st, pre: trk.gap_points_core(spec, st, pre, f_cap))(
        state, prev_pre)
    all_prev, all_valid = all_prev.contiguous(), all_valid.contiguous()
    all_cur, status = fk.lk_core(spec, prev_pre[1], cur_pre[1], all_prev,
                                 all_valid)
    draws = fk.ransac_draws_batch([int(s) for s in seeds], f_cap,
                                  all_prev.device)

    def one(*args):
        return trk.gap_commit_core(params.kf_cfg, spec,
                                   float(params.age_penalty),
                                   params.confirm_hits, *args)
    new_state, _ = vmap(one, in_dims=(0,) * 9 + (None,) * 3)(
        state, inside, f_tlbrs, f_valid, forder, all_prev, all_cur, status,
        draws, params.trans, params.acc_cov, params.frame_tlbr)
    return new_state


def assoc_step(params, frame_id, state, hist, dets, embs):
    """One association frame of every stream: ``dets`` (tlbr [S, D, 4],
    label, conf, valid [S, D]), ``embs`` [S, D, F]. Returns (new state,
    new history store, the cascade's col4row [S, T] after the
    finals)."""
    p = params
    n_depth = (p.max_age + 2) // 2
    fill_val = min(p.max_assoc_cost + 0.1, 1.0)
    costs_args = (p.kf_cfg, p.metric, n_depth, p.motion_weight,
                  p.max_assoc_cost, 1.0 - p.iou_thresh, fill_val,
                  p.occlusion_thresh, p.confirm_hits)
    (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
     base_iou_active, base_unconf, u_det, col4row) = vmap(
        lambda st, h, d, e: trk.assoc_costs_reference(*costs_args, st, h,
                                                      *d, e))(
        state, hist, dets, embs)
    n = len(depth_masks)
    u_det, col4row = trk.asg.cascade_auction(
        (cost, iou_cost), tuple(depth_masks) + (base_iou_active,
                                                base_unconf),
        (0,) * n + (1, 1), (False,) * n + (True, False), u_det, col4row,
        p.assoc_eps)
    u_det_conf, reid_c4r, rect_c4r = trk.finals_reference(
        p.conf_thresh, p.max_reid_cost, 1.0 - p.duplicate_thresh,
        p.confirm_hits, state[2], state[3], state[4], state[5], dets[0],
        dets[2], reid_cost, h_reid_ok, occluded, u_det, col4row)
    cascade_out = (occluded, col4row, u_det_conf, reid_c4r, rect_c4r)

    def one(st, h, d, e, casc):
        return trk.commit_part(p.kf_cfg, p.confirm_hits, p.max_age,
                               p.history_size, st, h, *d, e, int(frame_id),
                               p.frame_tlbr, casc)
    new_state, new_hist, _ = vmap(one)(state, hist, dets, embs,
                                       cascade_out)
    return new_state, new_hist, col4row
