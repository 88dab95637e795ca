"""Multi-object tracker: KLT + Kalman prediction and cascaded association.

Port of ``fastmot_tpu/tracker.py``. Same state machine: all tracking state
lives in fixed-capacity slot tensors on the device (``N_STATE`` per-track
tensors, ``N_HIST`` history-store tensors); each frame's decisions are
made there and recorded in a small flat info vector, and ``sync`` replays
the queued info vectors onto the host ``Track`` mirrors (IDs, logging,
txt output) with one transfer.

The per-frame pure functions keep the JAX package's names and arguments
(less the leading underscore) so each can be held against its JAX twin:
``gap_pre_core``, ``gap_points_core``, ``lk_commit_core``,
``gap_commit_core``, ``assoc_costs_core``, ``extract_costs_core``,
``stages_scan_core``, ``finals_core``, ``commit_part`` (with
``commit_core`` its dispatch) and ``scan_finals_commit_core``. They run
eagerly, one frame at a time: the JAX package's scan/chain kernels and its
split-dispatch variants are TPU dispatch structure and are not ported. A
gap frame's pre-LK half runs through ``ops.flow_kernels.preprocess`` and
``ops.gap_points.gap_points``
(on the card a kernel each; on the CPU their plain versions,
``preprocess_reference`` and ``gap_points_core``), its post-LK half
through ``ops.gap_commit.gap_commit``: on the card one launch of its kernel
for all of a call's streams, which draws the JAX package's RANSAC uniforms
for each flow seed bit for bit; on the CPU ``gap_commit_core`` (the plain
version, which takes the draws of ``ops.flow_kernels.ransac_draws`` as
``draws``). ``*_batch`` run the loop-free cores over a leading stream axis
(``parallel.StreamTracker``); ``stages_scan_core`` and ``finals_core``
take that axis themselves, and run their solvers through
``ops.assignment.cascade_auction`` and ``greedy_finals``: on the card the
whole cascade in one launch and the finals (their masks, the rectify cost
and both greedy matchings) in another, with no host sync; on the CPU the
plain solvers (``finals_reference``). The commit (``commit_core``, and
``commit_batch`` over streams) runs ``ops.assoc_commit.assoc_commit``: on
the card one call of its kernel for all of a call's streams, on the CPU
``commit_part``. ``compute_flow``/``apply_kalman`` are the JAX package's
legacy per-track API.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import torch
from torch.func import vmap

from . import kalman as kf
from .device import torch_device
from .feature_extractor import extract_core
from .flow import Flow
from .kalman import KalmanConfig
from .ops import assignment as asg
from .ops import assoc_costs as acost
from .ops import assoc_commit as ac
from .ops import distance as dist
from .ops import flow_kernels as fk
from .ops import gap_commit as gc
from .ops import gap_points as gp
from .ops import geometry as geom
from .track import Track
from .utils import profiler
from .utils.profiler import Profiler

LOGGER = logging.getLogger(__name__)

MAX_TRACKS = 128
MAX_DETS = 128
FEAT_DIM = 512

# device state tuple layout (per track slot)
#  0 means [T,8]   1 covs [T,8,8]  2 tlbrs [T,4]   3 valid [T]
#  4 ages [T]      5 hits [T]      6 labels [T]    7 start_f [T]
#  8 end_f [T]     9 lost_pending [T] (confirmed track lost in a gap
#                     frame; its features await a history save)
# 10 inl [T]      11 kps [T,K,2]  12 kpv [T,K]
# 13 feat_sum [T,F]  14 feat_count [T]
N_STATE = 15
# ops.gap_points and ops.gap_commit (imported above) keep this count to
# check a call's state, and read their fields by index (their STATE_IN)
assert gp.N_STATE == gc.N_STATE == N_STATE

# history store tuple layout (per history slot)
#  0 hist_sum [H,F]  1 hist_count [H]  2 h_labels [H]  3 h_valid [H]
#  4 h_lru [H] (insertion frame stamp)  5 h_hits [H]
N_HIST = 6

class OverflowCounters(dict):
    """Counts every fixed-capacity clip; warns once per kind."""

    def bump(self, kind: str, n: int = 1):
        if n <= 0:
            return
        if kind not in self:
            LOGGER.warning(
                'Capacity overflow: %s (+%d) — state beyond the fixed '
                'budget is clipped (see tracker.MAX_TRACKS/MAX_DETS, '
                'flow_kernels.MAX_FLOW_TRACKS/KP_PER_TRACK)', kind, n)
        self[kind] = self.get(kind, 0) + n


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def cfg_kwargs(cfg) -> dict:
    """A config section (None, SimpleNamespace or mapping) as kwargs."""
    if cfg is None:
        return {}
    if isinstance(cfg, SimpleNamespace):
        return vars(cfg)
    return dict(cfg)


def _scatter(size: int, idx: torch.Tensor, values, fill, dtype):
    """``full(size, fill).at[idx].set(values, mode='drop')``: entries of
    ``idx`` outside [0, size) are dropped. Out of place (``vmap``)."""
    dev = idx.device
    out = torch.full((size + 1,), fill, dtype=dtype, device=dev)
    idx = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size)).long()
    values = values.to(dtype) if isinstance(values, torch.Tensor) else \
        torch.tensor(values, dtype=dtype, device=dev)
    return out.index_put((idx,), values.expand(idx.shape))[:size]


def _set_rows(arr: torch.Tensor, idx: torch.Tensor, values: torch.Tensor):
    """``arr.at[idx].set(values, mode='drop')`` along axis 0."""
    size = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], 0)
    idx = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size)).long()
    return ext.index_put((idx,), values.to(arr.dtype))[:size]


def _first_true(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=n, fill_value=fill)[0]`` without a host
    sync: the True indices ascending, then ``fill``."""
    n = mask.shape[0]
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return torch.where(torch.arange(n, device=mask.device) < mask.sum(),
                       order, torch.full_like(order, fill))


def fetch_infos(infos):
    """Info vectors (device tensors, or None) as numpy arrays, after one
    device-to-host transfer."""
    dev_infos = [info for info in infos if info is not None]
    if not dev_infos:
        return list(infos)
    with Profiler('sync.fetch'):
        profiler.count('host_syncs')
        flat = torch.cat(dev_infos).cpu().numpy()
    out, off = [], 0
    for info in infos:
        if info is None:
            out.append(None)
        else:
            out.append(flat[off:off + info.numel()])
            off += info.numel()
    return out


def _flat_info(*arrays) -> torch.Tensor:
    return torch.cat([torch.as_tensor(a).to(torch.float32).reshape(-1)
                      for a in arrays])


# ---------------------------------------------------------------------------
# Gap frames: preprocess -> points -> LK -> RANSAC/Kalman/commit
# ---------------------------------------------------------------------------

def gap_pre_core(spec, cur_frame, state, prev_state, f_cap: int):
    """Current-frame preprocess + depth sort + corner management + LK point
    assembly (``ops.flow_kernels.preprocess`` and ``ops.gap_points.
    gap_points``: on the card a kernel each, on the CPU their plain
    versions)."""
    cur_state = fk.preprocess(spec, cur_frame)
    return (cur_state,) + gp.gap_points(spec, state, prev_state, f_cap)


def gap_points_core(spec, state, prev_state, f_cap: int):
    """Depth sort (near first) + corner management + LK point assembly
    over the first ``f_cap`` active tracks: the plain version of
    ``ops.gap_points.gap_points`` for one stream."""
    tlbrs, valid, ages, kps, kp_valid = (state[i] for i in gp.STATE_IN)
    active = valid & (ages < 2)
    key = -tlbrs[:, 3] + ages.to(torch.float32) * 1e-3
    key = torch.where(active, key, torch.full_like(key, float('inf')))
    forder = torch.argsort(key, stable=True)[:f_cap]
    f_valid = active[forder]
    f_tlbrs = tlbrs[forder]
    f_kps = kps[forder]
    f_kpv = kp_valid[forder] & f_valid[:, None]
    all_prev, all_valid, inside = fk.flow_points_core(
        spec, prev_state, f_tlbrs, f_valid, f_kps, f_kpv)
    return all_prev, all_valid, inside, forder, f_tlbrs, f_valid


def gap_commit_core(cfg: KalmanConfig, spec, age_penalty: float,
                    confirm_hits: int, state, inside, f_tlbrs, f_valid,
                    forder, all_prev, all_cur, status, draws,
                    trans, acc_cov, frame_tlbr):
    """RANSAC + Kalman warp/predict/update + validity commit of a gap
    frame. Returns (new_state, info)."""
    (means, covs, tlbrs, valid, ages, hits, labels, start_f, end_f,
     lost_pending, inl, kps, kp_valid, feat_sum, feat_count) = state
    dev = means.device
    t_cap = means.shape[0]
    f_cap = f_tlbrs.shape[0]
    active = valid & (ages < 2)

    (h_ok, h_mat, bg_prev, bg_cur, bg_inlier, est, est_valid, inl_ratio,
     trk_prev, trk_cur, out_kp_valid) = fk.flow_post_core(
        spec, f_tlbrs, f_valid, inside, all_prev, all_cur, status, *draws)

    pos = _scatter(t_cap, forder, torch.arange(f_cap, device=dev), f_cap,
                   torch.int64)
    in_flow = (pos < f_cap) & active
    slot = torch.clamp(pos, max=f_cap - 1)
    has_klt = in_flow & est_valid[slot]
    klt_tlbrs = est[slot]
    new_inl = torch.where(has_klt, inl_ratio[slot], inl)

    kps_new = torch.where(in_flow[:, None, None], trk_cur[slot], kps)
    kpv_new = torch.where(in_flow[:, None], out_kp_valid[slot], kp_valid)
    kpv_new = kpv_new & ~(in_flow & ~est_valid[slot])[:, None]

    mult = torch.clamp(age_penalty * ages.to(torch.float32), min=1.0) / \
        torch.clamp(new_inl, min=1e-6)
    h_use = torch.where(h_ok, h_mat.to(torch.float32),
                        torch.eye(3, device=dev))
    means, covs = kf.warp(means, covs, h_use)
    means, covs = kf.predict(cfg, means, covs, trans, acc_cov)
    up_means, up_covs = kf.update(
        cfg, means, covs, klt_tlbrs,
        torch.ones(t_cap, dtype=torch.bool, device=dev), mult)
    means = torch.where(has_klt[:, None], up_means, means)
    covs = torch.where(has_klt[:, None, None], up_covs, covs)
    next_tlbrs = geom.as_tlbr(means[:, :4])
    ios_vals = geom.ios(next_tlbrs, frame_tlbr.expand_as(next_tlbrs))

    lost = valid & (ios_vals < 0.5)
    new_valid = h_ok & valid & ~lost
    confirmed = hits >= confirm_hits
    # confirmed tracks lost here keep their features pending a history
    # save at the next association; camera failure clears without saving
    new_lost_pending = h_ok & (lost_pending | (lost & confirmed))
    kpv_new = kpv_new & h_ok & new_valid[:, None]
    new_tlbrs = torch.where(valid[:, None], next_tlbrs, tlbrs)

    new_state = (means, covs, new_tlbrs, new_valid, ages, hits, labels,
                 start_f, end_f, new_lost_pending, new_inl,
                 kps_new, kpv_new, feat_sum, feat_count)
    info = _flat_info(h_ok.reshape(-1), h_mat, next_tlbrs, lost, has_klt,
                      klt_tlbrs, new_inl, bg_prev, bg_cur, bg_inlier,
                      est_valid[slot] & in_flow)
    return new_state, info


def lk_commit_core(cfg: KalmanConfig, spec, age_penalty: float,
                   confirm_hits: int, prev_u8, cur_u8, all_prev, all_valid,
                   state, inside, f_tlbrs, f_valid, forder, seed,
                   trans, acc_cov, frame_tlbr):
    """Pyramidal LK, then the gap commit of the uint32 RANSAC ``seed``
    (``ops.gap_commit.gap_commit``: on the card one kernel launch with the
    draws made there, on the CPU ``gap_commit_core``)."""
    all_cur, status = fk.lk_core(spec, prev_u8, cur_u8, all_prev, all_valid)
    new_state, info = gc.gap_commit(
        cfg, spec, age_penalty, confirm_hits, tuple(a[None] for a in state),
        inside[None], f_tlbrs[None], f_valid[None], forder[None],
        all_prev[None], all_cur[None], status[None], [seed], trans, acc_cov,
        frame_tlbr)
    return tuple(a[0] for a in new_state), info[0]


# ---------------------------------------------------------------------------
# Association frames: ReID + costs -> cascade stages -> finals -> commit
# ---------------------------------------------------------------------------

def normalized_feats(feat_sum, feat_count):
    avg = feat_sum / torch.clamp(feat_count, min=1.0)[:, None]
    norm = torch.linalg.norm(avg, dim=1, keepdim=True)
    return avg / torch.where(norm > 0, norm, torch.ones_like(norm))


def split_feature_dists(metric: dist.Metric, feat_sum, feat_count,
                        hist_sum, hist_count, d_embeddings, psum):
    """The euclidean appearance distances of ``assoc_costs_core`` for
    every stream, ``([S, T, D], [S, H, D])`` (tracks and history entries
    against the detections), when each rank holds one slice of the feature
    axis (``'model'`` sharding of the 512-d ReID features): the partial
    sums of the norms and of the expansion's terms are completed by
    ``psum``, an in-place SUM all-reduce over the slices' ranks, in two
    calls (the averaged features' norms, then the terms). Outside
    ``vmap``, which admits no collective."""
    if metric != dist.Metric.EUCLIDEAN:
        raise ValueError(f'split features: {metric} is not supported')
    t = feat_sum.shape[1]
    avg = torch.cat([feat_sum / torch.clamp(feat_count, min=1.0)[..., None],
                     hist_sum / torch.clamp(hist_count, min=1.0)[..., None]],
                    1)
    sq = torch.sum(avg * avg, -1)
    psum(sq)
    norm = torch.sqrt(sq)[..., None]
    feats = avg / torch.where(norm > 0, norm, torch.ones_like(norm))
    terms = [torch.sum(feats * feats, -1), torch.sum(d_embeddings ** 2, -1),
             feats @ d_embeddings.transpose(1, 2)]
    flat = torch.cat([a.reshape(-1) for a in terms])
    psum(flat)
    y = dist.euclidean_from_terms(*(v.reshape(a.shape) for v, a in zip(
        flat.split([a.numel() for a in terms]), terms)))
    return y[:, :t], y[:, t:]


def assoc_costs_core(cfg: KalmanConfig, metric: dist.Metric, n_depth: int,
                     motion_weight: float, max_assoc_cost: float,
                     iou_gate: float, fill_val: float,
                     occlusion_thresh: float, confirm_hits: int,
                     state, hist, d_tlbrs, d_labels, d_conf, d_valid,
                     d_embeddings, emb_cap: int | None = None,
                     appearance=None):
    """Cost matrices + row masks of every cascade stage, one stream
    (``assoc_costs_reference``'s arguments and results): on the card one
    call of the costs kernels (``ops.assoc_costs.assoc_costs``, the
    tensors without a stream axis), on the CPU ``assoc_costs_reference``;
    any other device raises."""
    device = d_tlbrs.device
    if device.type == 'cpu':
        return assoc_costs_reference(
            cfg, metric, n_depth, motion_weight, max_assoc_cost, iou_gate,
            fill_val, occlusion_thresh, confirm_hits, state, hist, d_tlbrs,
            d_labels, d_conf, d_valid, d_embeddings, emb_cap, appearance)
    if device.type != 'cuda':
        raise ValueError(f'assoc_costs_core: unsupported device {device}')
    return acost.assoc_costs(
        cfg, metric, n_depth, motion_weight, max_assoc_cost, iou_gate,
        fill_val, occlusion_thresh, confirm_hits, state, hist,
        (d_tlbrs, d_labels, d_conf, d_valid), d_embeddings, emb_cap,
        appearance)


def assoc_costs_reference(cfg: KalmanConfig, metric: dist.Metric,
                          n_depth: int, motion_weight: float,
                          max_assoc_cost: float, iou_gate: float,
                          fill_val: float, occlusion_thresh: float,
                          confirm_hits: int, state, hist, d_tlbrs, d_labels,
                          d_conf, d_valid, d_embeddings,
                          emb_cap: int | None = None, appearance=None):
    """Cost matrices + row masks of every cascade stage: the plain version
    of ``ops.assoc_costs.assoc_costs``. Detections at index >= ``emb_cap``
    carry no embedding and are treated like occluded ones (appearance-free
    association, no reID, no feature absorption). ``appearance``: the two
    unmasked appearance distances, computed apart
    (``split_feature_dists``); None computes them here."""
    (means, covs, tlbrs, t_valid, ages, hits, t_labels, start_f, end_f,
     lost_pending, inl, kps, kpv, feat_sum, feat_count) = state
    hist_sum, hist_count, h_labels, h_valid, h_lru, h_hits = hist
    t_confirmed = hits >= confirm_hits
    t_active = ages < 2
    t_depth = ages // 2
    h_reid_ok = h_valid & (hist_count >= 2.0)

    occluded = geom.find_occluded(d_tlbrs, occlusion_thresh, d_valid)
    if emb_cap is not None and emb_cap < d_tlbrs.shape[0]:
        occluded = occluded | (torch.arange(d_tlbrs.shape[0],
                                            device=d_tlbrs.device) >= emb_cap)
    if appearance is None:
        appearance = tuple(
            dist.cdist(normalized_feats(f_sum, count), d_embeddings, metric)
            for f_sum, count in ((feat_sum, feat_count),
                                 (hist_sum, hist_count)))
    t_app, h_app = appearance
    empty = (feat_count < 1.0)[:, None] | occluded[None, :]
    cost = torch.where(empty, torch.full_like(t_app, fill_val), t_app)
    m_dist = kf.maha_distance(cfg, means, covs, d_tlbrs)
    cost = asg.fuse_motion(cost, m_dist, motion_weight)
    cost = asg.gate_cost(cost, t_labels, d_labels, max_assoc_cost)

    iou_cost = asg.gate_cost(dist.iou_dist(tlbrs, d_tlbrs), t_labels,
                             d_labels, iou_gate)
    reid_cost = asg.gate_cost(h_app, h_labels, d_labels)

    depth_masks = tuple(t_valid & t_confirmed & (t_depth == d)
                        for d in range(n_depth))
    base_iou_active = t_valid & t_confirmed & t_active
    base_unconfirmed = t_valid & ~t_confirmed
    col4row0 = torch.full((tlbrs.shape[0],), -1, dtype=torch.int32,
                          device=tlbrs.device)
    return (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
            base_iou_active, base_unconfirmed, d_valid, col4row0)


def extract_costs_core(module, out_hw, emb_cap: int, cfg: KalmanConfig,
                       metric: dist.Metric, n_depth: int,
                       motion_weight: float, max_assoc_cost: float,
                       iou_gate: float, fill_val: float,
                       occlusion_thresh: float, confirm_hits: int,
                       frame, state, hist, d_tlbrs, d_labels, d_conf,
                       d_valid):
    """ReID embeddings of the first ``emb_cap`` detections (crop-resize,
    OSNet, L2) + ``assoc_costs_core``. Returns (costs, d_emb [D, F])."""
    d_cap = d_tlbrs.shape[0]
    emb = extract_core(module, out_hw, frame, d_tlbrs[:emb_cap],
                       d_valid[:emb_cap])
    if emb_cap < d_cap:
        d_emb = torch.zeros((d_cap, emb.shape[1]), dtype=torch.float32,
                            device=emb.device)
        d_emb[:emb_cap] = emb
    else:
        d_emb = emb
    costs = assoc_costs_core(
        cfg, metric, n_depth, motion_weight, max_assoc_cost, iou_gate,
        fill_val, occlusion_thresh, confirm_hits, state, hist,
        d_tlbrs, d_labels, d_conf, d_valid, d_emb, emb_cap=emb_cap)
    return costs, d_emb


def stages_scan_core(n_depth: int, cost, iou_cost, depth_masks,
                     base_iou_active, base_unconfirmed, u_det, col4row,
                     eps: float = 1e-2, forbid: float = asg.FORBID):
    """All cascade auction stages in order: the appearance+motion stages
    per age bucket, the IoU stage of active confirmed tracks (which skips
    rows already matched), the IoU stage of unconfirmed tracks. One
    ``asg.cascade_auction`` call: on the card one launch for every stage
    and stream, with no host sync."""
    n = len(depth_masks)
    return asg.cascade_auction(
        (cost, iou_cost), tuple(depth_masks) + (base_iou_active,
                                                base_unconfirmed),
        (0,) * n + (1, 1), (False,) * n + (True, False), u_det, col4row,
        eps, forbid=forbid)


def finals_core(conf_thresh: float, max_reid_cost: float, dup_gate: float,
                confirm_hits: int, tlbrs, t_valid, ages, hits, d_tlbrs,
                d_conf, reid_cost, h_reid_ok, occluded, u_det,
                col4row_final):
    """Greedy reID against the history store + duplicate-rectify
    candidates: (u_det_conf, reid_c4r, rect_c4r). Takes a leading stream
    axis on every tensor. On the card one launch of the greedy kernel
    computes the masks, the rectify cost and both matches
    (``asg.greedy_finals``); on the CPU ``finals_reference``; any other
    device raises."""
    device = tlbrs.device
    if device.type == 'cuda':
        return asg.greedy_finals(
            conf_thresh, max_reid_cost, dup_gate, confirm_hits, tlbrs,
            t_valid, ages, hits, d_tlbrs, d_conf, reid_cost, h_reid_ok,
            occluded, u_det, col4row_final)
    if device.type != 'cpu':
        raise ValueError(f'finals_core: unsupported device {device}')
    return finals_reference(
        conf_thresh, max_reid_cost, dup_gate, confirm_hits, tlbrs, t_valid,
        ages, hits, d_tlbrs, d_conf, reid_cost, h_reid_ok, occluded, u_det,
        col4row_final)


def finals_reference(conf_thresh: float, max_reid_cost: float,
                     dup_gate: float, confirm_hits: int, tlbrs, t_valid, ages,
                     hits, d_tlbrs, d_conf, reid_cost, h_reid_ok, occluded,
                     u_det, col4row_final):
    """The plain version of ``finals_core``: the masks and the rectify cost
    as torch ops, then both greedy problems in one ``asg.greedy_match``
    call (the rectify cost depends only on the cascade's matches)."""
    t_confirmed = hits >= confirm_hits
    t_active = ages < 2
    u_det_conf = u_det & (d_conf >= conf_thresh)
    reid_cols = u_det_conf & ~occluded
    matched_mask = col4row_final >= 0
    inactive_matched = matched_mask & ~t_active
    u_active = t_valid & t_confirmed & t_active & ~matched_mask
    safe_col = torch.where(matched_mask, col4row_final,
                           torch.zeros_like(col4row_final)).long()
    rect_cost = dist.iou_dist(
        tlbrs, torch.take_along_dim(d_tlbrs, safe_col[..., None], dim=-2))
    (_, reid_c4r), (_, rect_c4r) = asg.greedy_match((
        (reid_cost, h_reid_ok, reid_cols, max_reid_cost),
        (rect_cost, u_active, inactive_matched, dup_gate)))
    return u_det_conf, reid_c4r, rect_c4r


def commit_core(cfg: KalmanConfig, confirm_hits: int, max_age: int,
                history_size: int, state, hist, d_tlbrs, d_labels, d_conf,
                d_valid, d_emb, frame_id: int, frame_tlbr, cascade_out):
    """``commit_part``'s arguments and results, one stream, through
    ``ops.assoc_commit.assoc_commit``: on the card one call of the commit
    kernel, on the CPU ``commit_part``; any other device raises."""
    return ac.assoc_commit(cfg, confirm_hits, max_age, history_size, state,
                           hist, (d_tlbrs, d_labels, d_conf, d_valid),
                           d_emb, frame_id, frame_tlbr, cascade_out)


def commit_part(cfg: KalmanConfig, confirm_hits: int, max_age: int,
                history_size: int, state, hist, d_tlbrs, d_labels, d_conf,
                d_valid, d_emb, frame_id: int, frame_tlbr, cascade_out):
    """Lifecycle decisions + state commit of an association frame, with
    slot and history allocation. Returns (new_state, new_hist, info). The
    plain version of ``ops.assoc_commit.assoc_commit`` (its
    ``commit_reference``), which the card runs in one call of its kernel."""
    (means, covs, tlbrs, valid, ages, hits, labels, start_f, end_f,
     lost_pending, inl, kps, kpv, feat_sum, feat_count) = state
    hist_sum, hist_count, h_labels, h_valid, h_lru, h_hits = hist
    dev = means.device
    t_cap = means.shape[0]
    d_cap = d_tlbrs.shape[0]
    h_cap = hist_sum.shape[0]
    i32 = torch.int32
    t_idx = torch.arange(t_cap, dtype=i32, device=dev)
    d_idx = torch.arange(d_cap, dtype=i32, device=dev)
    h_idx = torch.arange(h_cap, dtype=i32, device=dev)

    def take(arr, idx):
        return arr[idx.long()]

    confirmed = hits >= confirm_hits
    h_reid_ok = h_valid & (hist_count >= 2.0)
    occluded, col4row, u_det_conf, reid_c4r, rect_c4r = cascade_out

    # ---- rectify: merge vs duplicate ---------------------------------------
    has_rect = rect_c4r >= 0
    j = torch.where(has_rect, rect_c4r, torch.zeros_like(rect_c4r))
    merge_cond = has_rect & (take(end_f, j) < start_f)
    dup_cond = has_rect & ~merge_cond
    merge_src = _scatter(t_cap, torch.where(merge_cond, j, -1), t_idx, -1,
                         i32)
    merged_away = merge_cond
    dup_det = take(col4row, j)
    col4row = torch.where(dup_cond, dup_det, col4row)
    col4row = torch.where(
        _scatter(t_cap, torch.where(dup_cond, j, -1), True, False,
                 torch.bool), torch.full_like(col4row, -1), col4row)

    # ---- lifecycle decisions ------------------------------------------------
    matched = (col4row >= 0) & valid & ~merged_away
    col4row = torch.where(matched, col4row, torch.full_like(col4row, -1))
    live = valid & ~merged_away
    unmatched = live & ~matched
    aged = ages + 1
    del_unconf = unmatched & ~confirmed
    retire_age = unmatched & confirmed & (aged > max_age)
    keep_unmatched = unmatched & ~del_unconf & ~retire_age

    reinstated_h = (reid_c4r >= 0) & h_reid_ok
    reid_det = torch.where(reinstated_h, reid_c4r, torch.zeros_like(reid_c4r))
    taken = _scatter(d_cap, torch.where(reinstated_h, reid_det, -1), True,
                     False, torch.bool)
    create_mask = u_det_conf & (occluded | ~taken) & d_valid

    free = (~valid) | merged_away | del_unconf | retire_age
    free_idx = _first_true(free, t_cap)
    n_free = free.sum()
    r_rank = torch.cumsum(reinstated_h.to(torch.int64), 0) - 1
    n_reid_req = reinstated_h.sum()
    c_rank = n_reid_req + torch.cumsum(create_mask.to(torch.int64), 0) - 1
    r_ok = reinstated_h & (r_rank < n_free)
    c_ok = create_mask & (c_rank < n_free)
    slot_of_reid = torch.where(r_ok, free_idx[torch.clamp(r_rank, 0,
                                                          t_cap - 1)],
                               torch.full_like(r_rank, t_cap))
    slot_of_create = torch.where(c_ok, free_idx[torch.clamp(c_rank, 0,
                                                            t_cap - 1)],
                                 torch.full_like(c_rank, t_cap))
    n_dropped = (n_reid_req - r_ok.sum()) + (create_mask.sum() - c_ok.sum())

    reinstate_hist = _scatter(t_cap, slot_of_reid, h_idx, -1, i32)
    create_det = _scatter(t_cap, slot_of_create, d_idx, -1, i32)
    create_det = _set_rows(create_det, slot_of_reid,
                           torch.where(r_ok, reid_det,
                                       torch.zeros_like(reid_det)))

    match_det = torch.where(matched, col4row, torch.full_like(col4row, -1))
    feat_ok = matched & ~take(occluded, torch.where(
        matched, col4row, torch.zeros_like(col4row)))
    re = reinstate_hist >= 0
    c = create_det >= 0

    # ---- commit: merges -----------------------------------------------------
    has_merge = merge_src >= 0
    src = torch.where(has_merge, merge_src, t_idx).long()
    means = torch.where(has_merge[:, None], means[src], means)
    covs = torch.where(has_merge[:, None, None], covs[src], covs)
    tlbrs = torch.where(has_merge[:, None], tlbrs[src], tlbrs)
    inl = torch.where(has_merge, inl[src], inl)
    kps = torch.where(has_merge[:, None, None], kps[src], kps)
    kpv = torch.where(has_merge[:, None], kpv[src], kpv)
    feat_sum = torch.where(has_merge[:, None], feat_sum + feat_sum[src],
                           feat_sum)
    feat_count = torch.where(has_merge, feat_count + feat_count[src],
                             feat_count)
    hits = torch.where(has_merge, hits + hits[src], hits)

    # ---- reinstates read the pre-save history -------------------------------
    rh = torch.where(re, reinstate_hist, torch.zeros_like(reinstate_hist))
    feat_sum = torch.where(re[:, None], take(hist_sum, rh), feat_sum)
    feat_count = torch.where(re, take(hist_count, rh), feat_count)
    re_hits = take(h_hits, rh)

    # ---- matched Kalman corrections -----------------------------------------
    m = match_det >= 0
    z = take(d_tlbrs, torch.where(m, match_det, torch.zeros_like(match_det)))
    up_means, up_covs = kf.update(
        cfg, means, covs, z, torch.zeros(t_cap, dtype=torch.bool, device=dev),
        torch.ones(t_cap, dtype=torch.float32, device=dev))
    means = torch.where(m[:, None], up_means, means)
    covs = torch.where(m[:, None, None], up_covs, covs)

    # ---- creations (new + reinstated): state from detection -----------------
    cdet = torch.where(c, create_det, torch.zeros_like(create_det))
    cr_means, cr_covs = kf.create(cfg, take(d_tlbrs, cdet))
    means = torch.where(c[:, None], cr_means, means)
    covs = torch.where(c[:, None, None], cr_covs, covs)
    kpv = kpv & ~c[:, None]
    inl = torch.where(c, torch.ones_like(inl), inl)
    fresh = c & ~re
    feat_sum = torch.where(fresh[:, None], torch.zeros_like(feat_sum),
                           feat_sum)
    feat_count = torch.where(fresh, torch.zeros_like(feat_count), feat_count)

    # ---- boxes / out-of-frame before feature absorption ---------------------
    next_tlbrs = geom.as_tlbr(means[:, :4])
    ios_vals = geom.ios(next_tlbrs, frame_tlbr.expand_as(next_tlbrs))
    out_of_frame = (m | c) & (ios_vals < 0.5)

    # ---- feature updates ----------------------------------------------------
    det_of = torch.where(m, match_det, cdet)
    emb = take(d_emb, det_of)
    upd = (m & feat_ok & ~out_of_frame) | (c & re)
    feat_sum = torch.where(upd[:, None], feat_sum + emb, feat_sum)
    feat_count = torch.where(upd, feat_count + 1.0, feat_count)
    tlbrs = torch.where((m | c)[:, None], next_tlbrs, tlbrs)

    # ---- bookkeeping fields -------------------------------------------------
    new_hits = torch.where(m, hits + 1, hits)
    new_hits = torch.where(re, re_hits, new_hits)
    new_hits = torch.where(fresh, torch.zeros_like(new_hits), new_hits)
    new_ages = torch.where(m | c, torch.zeros_like(ages),
                           torch.where(keep_unmatched, aged, ages))
    new_labels = torch.where(c, take(d_labels, cdet).to(labels.dtype),
                             labels)
    new_labels = torch.where(re, take(h_labels, rh), new_labels)
    new_start = torch.where(c, torch.full_like(start_f, frame_id), start_f)
    new_end = torch.where(m | c, torch.full_like(end_f, frame_id), end_f)
    confirmed_after = new_hits >= confirm_hits
    new_valid = (m & ~out_of_frame) | keep_unmatched | (c & ~out_of_frame)

    # ---- history maintenance ------------------------------------------------
    # clear reinstated entries, then save retiring tracks' features:
    # gap-frame losses (lost_pending), age-outs, and out-of-frame exits
    h_valid2 = h_valid & ~(reinstated_h & r_ok)
    save_mask = lost_pending | retire_age | (out_of_frame & confirmed_after)
    # allocation order: invalid slots ascending, then oldest LRU
    alloc_key = torch.where(h_valid2, h_lru.to(torch.float32),
                            -1e9 + h_idx.to(torch.float32))
    alloc_order = torch.argsort(alloc_key, stable=True).to(i32)
    s_rank = torch.cumsum(save_mask.to(torch.int64), 0) - 1
    hist_dst = torch.where(save_mask,
                           alloc_order[torch.clamp(s_rank, 0, h_cap - 1)],
                           torch.full_like(s_rank, -1, dtype=i32))
    hist_dst = torch.where(save_mask & (s_rank < h_cap), hist_dst,
                           torch.full_like(hist_dst, -1))
    has_dst = hist_dst >= 0
    stolen = (has_dst & take(h_valid2, torch.where(
        has_dst, hist_dst, torch.zeros_like(hist_dst)))).sum()
    hs = torch.where(has_dst, hist_dst, torch.full_like(hist_dst, h_cap))
    hist_sum2 = _set_rows(hist_sum, hs, feat_sum)
    hist_count2 = _set_rows(hist_count, hs, feat_count)
    h_labels2 = _set_rows(h_labels, hs, labels)
    h_lru2 = _set_rows(h_lru, hs, torch.full_like(hs, frame_id))
    h_hits2 = _set_rows(h_hits, hs, new_hits)
    h_valid2 = _set_rows(h_valid2, hs, torch.ones_like(has_dst))
    # cap the store at history_size by evicting oldest-inserted entries
    excess = torch.clamp(h_valid2.sum() - history_size, min=0)
    lru_key = torch.where(h_valid2, h_lru2.to(torch.float32),
                          torch.full_like(alloc_key, float('inf')))
    lru_rank = torch.argsort(torch.argsort(lru_key, stable=True),
                             stable=True)
    evict = h_valid2 & (lru_rank < excess)
    h_valid_final = h_valid2 & ~evict

    new_state = (means, covs, tlbrs, new_valid, new_ages, new_hits,
                 new_labels, new_start, new_end,
                 torch.zeros_like(lost_pending), inl, kps, kpv, feat_sum,
                 feat_count)
    new_hist = (hist_sum2, hist_count2, h_labels2, h_valid_final, h_lru2,
                h_hits2)
    head = torch.stack([torch.full((), frame_id, dtype=torch.float32,
                                   device=dev),
                        n_dropped.to(torch.float32),
                        stolen.to(torch.float32),
                        d_valid.sum().to(torch.float32)])
    info = _flat_info(head, match_det, merge_src, dup_cond, del_unconf,
                      retire_age, out_of_frame, hist_dst, reinstate_hist,
                      create_det, new_ages, new_hits, new_labels, new_valid,
                      feat_ok, evict, next_tlbrs, means, covs)
    return new_state, new_hist, info


def scan_finals_commit_core(cfg: KalmanConfig, n_depth: int,
                            conf_thresh: float, max_reid_cost: float,
                            dup_gate: float, confirm_hits: int,
                            max_age: int, history_size: int,
                            eps: float, forbid: float,
                            cost, iou_cost, depth_masks, base_iou_active,
                            base_unconfirmed, u_det, col4row,
                            state, hist, d_tlbrs, d_labels, d_conf,
                            d_valid, d_emb, frame_id, frame_tlbr,
                            reid_cost, h_reid_ok, occluded):
    """Cascade stages + greedy finals + lifecycle commit
    (``commit_core``: on the card a kernel call each, no host sync)."""
    u_det, col4row = stages_scan_core(
        n_depth, cost, iou_cost, depth_masks, base_iou_active,
        base_unconfirmed, u_det, col4row, eps=eps, forbid=forbid)
    u_det_conf, reid_c4r, rect_c4r = finals_core(
        conf_thresh, max_reid_cost, dup_gate, confirm_hits,
        state[2], state[3], state[4], state[5], d_tlbrs, d_conf,
        reid_cost, h_reid_ok, occluded, u_det, col4row)
    return commit_core(
        cfg, confirm_hits, max_age, history_size, state, hist,
        d_tlbrs, d_labels, d_conf, d_valid, d_emb, frame_id, frame_tlbr,
        (occluded, col4row, u_det_conf, reid_c4r, rect_c4r))


# ---------------------------------------------------------------------------
# Stream axis: the loop-free cores under torch.func.vmap over [S, ...]
# state; the cores around solvers (LK, the auction and greedy solvers in
# stages_scan_core and finals_core) take the leading axis themselves
# ---------------------------------------------------------------------------

def gap_points_batch(spec, f_cap: int, states, prev_states):
    """``gap_points_core`` for every stream of [S, ...] state and flow
    state."""
    return vmap(lambda st, pre: gap_points_core(spec, st, pre, f_cap))(
        states, prev_states)


def gap_commit_batch(cfg: KalmanConfig, spec, age_penalty: float,
                     confirm_hits: int, states, inside, f_tlbrs, f_valid,
                     forder, all_prev, all_cur, status, draws, trans,
                     acc_cov, frame_tlbr):
    """``gap_commit_core`` for every stream; ``draws`` are each stream's
    RANSAC uniforms ``(u_h [S, ...], u_a [S, ...])``."""
    def one(*args):
        return gap_commit_core(cfg, spec, age_penalty, confirm_hits, *args)
    return vmap(one, in_dims=(0,) * 9 + (None,) * 3)(
        states, inside, f_tlbrs, f_valid, forder, all_prev, all_cur,
        status, draws, trans, acc_cov, frame_tlbr)


def assoc_costs_batch(params, states, hists, dets, embs, feature_psum=None):
    """``assoc_costs_core(*params, ...)`` for every stream; ``dets`` is
    ``(tlbr [S, D, 4], label, conf, valid)``, ``embs`` [S, D, F]. On the
    card one launch of the costs kernel for all of them, on the CPU
    ``assoc_costs_reference`` under ``vmap``; any other device raises.
    ``feature_psum``: the features are a slice of the feature axis, whose
    partial sums this all-reduces (``split_feature_dists``), and the
    kernel takes the two distances."""
    device = dets[0].device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'assoc_costs_batch: unsupported device {device}')
    app = None if feature_psum is None else split_feature_dists(
        params[1], states[13], states[14], hists[0], hists[1], embs,
        feature_psum)
    if device.type == 'cuda':
        return acost.assoc_costs(*params, states, hists, dets, embs,
                                 appearance=app)
    if app is None:
        def one(state, hist, det, emb):
            return assoc_costs_reference(*params, state, hist, *det, emb)
        return vmap(one)(states, hists, dets, embs)

    def one_split(state, hist, det, emb, app):
        return assoc_costs_reference(*params, state, hist, *det, emb,
                                     appearance=app)
    return vmap(one_split)(states, hists, dets, embs, app)


def commit_batch(cfg: KalmanConfig, confirm_hits: int, max_age: int,
                 history_size: int, states, hists, dets, embs,
                 frame_id: int, frame_tlbr, cascade_out):
    """``commit_part`` for every stream (``ops.assoc_commit.assoc_commit``):
    on the card one call of the commit kernel for all of them, on the CPU
    ``commit_part`` under ``vmap``; any other device raises."""
    return ac.assoc_commit(cfg, confirm_hits, max_age, history_size, states,
                           hists, dets, embs, frame_id, frame_tlbr,
                           cascade_out)


def apply_kalman_core(cfg: KalmanConfig, means, covs, h_mat, trans, acc_cov,
                      klt_tlbrs, has_klt, multipliers, frame_tlbr):
    """Warp -> predict -> masked KLT update of the legacy
    ``compute_flow``/``apply_kalman`` path."""
    means, covs = kf.warp(means, covs, h_mat)
    means, covs = kf.predict(cfg, means, covs, trans, acc_cov)
    up_means, up_covs = kf.update(
        cfg, means, covs, klt_tlbrs,
        torch.ones(means.shape[0], dtype=torch.bool, device=means.device),
        multipliers)
    means = torch.where(has_klt[:, None], up_means, means)
    covs = torch.where(has_klt[:, None, None], up_covs, covs)
    next_tlbrs = geom.as_tlbr(means[:, :4])
    ios_vals = geom.ios(next_tlbrs, frame_tlbr.expand_as(next_tlbrs))
    return means, covs, next_tlbrs, ios_vals


class MultiTracker:
    """Tracks multiple objects, associating detections by motion and
    appearance. The device state lives on ``device``."""

    def __init__(self, size, metric,
                 max_age=6,
                 age_penalty=2,
                 motion_weight=0.2,
                 max_assoc_cost=0.9,
                 max_reid_cost=0.45,
                 iou_thresh=0.4,
                 duplicate_thresh=0.8,
                 occlusion_thresh=0.7,
                 conf_thresh=0.5,
                 confirm_hits=1,
                 history_size=50,
                 kalman_filter_cfg=None,
                 flow_cfg=None,
                 assoc_eps=1e-2,
                 device='cuda'):
        self.size = size
        self.device = torch_device(device)
        self.metric = metric if isinstance(metric, dist.Metric) \
            else dist.Metric[str(metric).upper()]
        assert max_age >= 1
        self.max_age = max_age
        assert age_penalty >= 1
        self.age_penalty = age_penalty
        assert 0 <= motion_weight <= 1
        self.motion_weight = motion_weight
        assert 0 <= max_assoc_cost <= 2
        self.max_assoc_cost = max_assoc_cost
        assert 0 <= max_reid_cost <= 2
        self.max_reid_cost = max_reid_cost
        assert 0 <= iou_thresh <= 1
        self.iou_thresh = iou_thresh
        assert 0 <= duplicate_thresh <= 1
        self.duplicate_thresh = duplicate_thresh
        assert 0 <= occlusion_thresh <= 1
        self.occlusion_thresh = occlusion_thresh
        assert 0 <= conf_thresh <= 1
        self.conf_thresh = conf_thresh
        assert confirm_hits >= 1
        self.confirm_hits = confirm_hits
        assert history_size >= 0
        self.history_size = history_size
        self._hist_cap = _bucket(max(history_size, 1))
        # auction tolerance: 1e-2 in production; tests pass 1e-4 to pin
        # exact-optimum tie-breaks
        assert 0 < assoc_eps <= 1
        self.assoc_eps = float(assoc_eps)

        self.kf_cfg = KalmanConfig(**cfg_kwargs(kalman_filter_cfg))
        self.tracks: dict[int, Track] = {}
        self.hist_tracks: OrderedDict[int, Track] = OrderedDict()
        self.flow = Flow(self.size, device=self.device,
                         **cfg_kwargs(flow_cfg))
        self.frame_rect = np.array([0, 0, size[0] - 1, size[1] - 1],
                                   np.float32)
        self._frame_rect_dev = torch.as_tensor(self.frame_rect,
                                               device=self.device)
        self.klt_bboxes: dict[int, np.ndarray] = {}
        self.homography = None
        self._set_dt(1 / 30.0)

        # device-resident state + host presentation mirrors
        self._dev_state = None
        self._hist_store = None
        self._slot_ids: list = [None] * MAX_TRACKS   # slot -> trk_id
        self._hist_slot_tid: dict[int, int] = {}     # hist slot -> trk_id
        self._pending: list = []                     # (kind, meta, info)
        self._mirrors_dirty = True        # host mirrors are authoritative
        self._det_count_hint = 0          # from the last applied assoc info
        self.overflow = OverflowCounters()

    def _set_dt(self, dt):
        self._dt = dt
        self._acc_cov, _, self._trans_mat = (
            torch.as_tensor(a, device=self.device)
            for a in kf.init_mats(self.kf_cfg, dt))

    # -- lifecycle ---------------------------------------------------------

    def reset(self, dt):
        """Reset for a new input context."""
        self._set_dt(dt)
        self.hist_tracks.clear()
        self._hist_slot_tid.clear()
        self._hist_store = None
        self._det_count_hint = 0
        Track._count = 0

    def init(self, frame, detections):
        """Initialize from detections in the first frame."""
        self._pending = []
        self.tracks.clear()
        self._slot_ids = [None] * MAX_TRACKS
        self.flow.init(frame)
        n = min(len(detections), MAX_DETS)
        self.overflow.bump('detections_clipped', len(detections) - MAX_DETS)
        if n:
            tlbrs = np.zeros((MAX_DETS, 4), np.float32)
            tlbrs[:n] = detections.tlbr[:n]
            profiler.count('host_syncs', 3)     # the upload, two reads
            means, covs = (t.cpu().numpy() for t in kf.create(
                self.kf_cfg, torch.as_tensor(tlbrs, device=self.device)))
            for i, det in enumerate(detections[:n]):
                new_trk = Track(0, det.tlbr, (means[i], covs[i]), det.label,
                                self.confirm_hits)
                self.tracks[new_trk.trk_id] = new_trk
                self._slot_ids[i] = new_trk.trk_id
                LOGGER.debug(f"{'Detected:':<14}{new_trk}")
        self._mirrors_dirty = True
        self._upload_state()
        # frame marker so buffered consumers snapshot the init frame too
        self._pending.append(('mark', {'frame_id': 0}, None))

    # -- tracking-only frames ----------------------------------------------

    def track(self, frame, frame_id=None):
        """Tracking-only frame: flow + Kalman on the device, no host sync
        of the decisions. ``frame_id`` tags the info for snapshots."""
        if self.flow.device_state is None:
            self.flow.init(frame)
            return
        if self._dev_state is None or self._mirrors_dirty:
            self._upload_state()
        n_active = sum(1 for t in self.tracks.values() if t.active)
        self.overflow.bump('flow_tracks_clipped',
                           n_active - fk.MAX_FLOW_TRACKS)
        f_cap = fk.flow_budget(n_active)
        spec = self.flow.spec
        prev_state = self.flow.device_state
        (cur_state, all_prev, all_valid, inside, forder, f_tlbrs,
         f_valid) = gap_pre_core(spec, frame, self._dev_state, prev_state,
                                 f_cap)
        new_state, info = lk_commit_core(
            self.kf_cfg, spec, float(self.age_penalty), self.confirm_hits,
            prev_state[1], cur_state[1], all_prev, all_valid,
            self._dev_state, inside, f_tlbrs, f_valid, forder,
            self.flow.seed,
            self._trans_mat, self._acc_cov, self._frame_rect_dev)
        self._dev_state = new_state
        self.flow.advance(cur_state)
        self._pending.append(('gap', {'slot_ids': list(self._slot_ids),
                                      'frame_id': frame_id}, info))

    def track_chain(self, frames, frame_ids):
        """Consecutive tracking-only frames: ``track`` on each."""
        for f, fid in zip(frames, frame_ids):
            self.track(f, fid)

    # -- association ----------------------------------------------------------

    def _assoc_params(self):
        n_depth = (self.max_age + 2) // 2
        fill_val = min(self.max_assoc_cost + 0.1, 1.0)
        return (self.kf_cfg, self.metric, n_depth, self.motion_weight,
                self.max_assoc_cost, 1.0 - self.iou_thresh, fill_val,
                self.occlusion_thresh, self.confirm_hits)

    def update(self, frame_id, detections, embeddings):
        """Host-array association entry (recarray detections + [N, D]
        embeddings). Synchronous: mirrors are current on return."""
        n_det = min(len(detections), MAX_DETS)
        self.overflow.bump('detections_clipped', len(detections) - MAX_DETS)
        feat_dim = embeddings.shape[1] if embeddings is not None and \
            getattr(embeddings, 'ndim', 0) == 2 and embeddings.shape[0] \
            else FEAT_DIM
        d_tlbrs = np.zeros((MAX_DETS, 4), np.float32)
        d_labels = np.full(MAX_DETS, -1, np.int32)
        d_conf = np.zeros(MAX_DETS, np.float32)
        d_valid = np.zeros(MAX_DETS, bool)
        d_emb = np.zeros((MAX_DETS, feat_dim), np.float32)
        if n_det:
            d_tlbrs[:n_det] = detections.tlbr[:n_det]
            d_labels[:n_det] = detections.label[:n_det]
            d_conf[:n_det] = detections.conf[:n_det]
            d_valid[:n_det] = True
            if embeddings is not None and len(embeddings):
                d_emb[:n_det] = embeddings[:n_det]
        profiler.count('host_syncs', 5)     # the detections' uploads
        det_dev = tuple(torch.as_tensor(a, device=self.device)
                        for a in (d_tlbrs, d_labels, d_conf, d_valid))
        self.update_device(frame_id, det_dev,
                           torch.as_tensor(d_emb, device=self.device),
                           host_emb=d_emb)
        self.sync()

    def update_device(self, frame_id, det_dev, emb_dev, host_emb=None):
        """Association from device tensors; decisions are replayed at the
        next ``sync``."""
        if self._dev_state is None or self._mirrors_dirty:
            self._upload_state()
        self._ensure_hist_store()
        costs = assoc_costs_core(*self._assoc_params(), self._dev_state,
                                 self._hist_store, *det_dev, emb_dev)
        self._stages_and_commit(frame_id, det_dev, emb_dev, costs,
                                host_emb=host_emb)

    @torch.no_grad()
    def update_device_fused(self, frame_id, frame_dev, det_dev, extractor):
        """Association with the ReID extraction on the same device
        tensors: crops + OSNet + L2 over a crop budget of 64 when the scene
        is small, the full padded batch otherwise. Detections beyond the
        budget associate appearance-free like occluded ones."""
        if self._dev_state is None or self._mirrors_dirty:
            self._upload_state()
        self._ensure_hist_store()
        d_cap = int(det_dev[0].shape[0])
        n_active = sum(1 for t in self.tracks.values() if t.active)
        est = max(n_active, self._det_count_hint)
        emb_cap = 64 if (est <= 56 and d_cap > 64) else d_cap
        costs, emb_dev = extract_costs_core(
            extractor.module, extractor.out_hw, emb_cap,
            *self._assoc_params(), frame_dev, self._dev_state,
            self._hist_store, *det_dev)
        self._stages_and_commit(frame_id, det_dev, emb_dev, costs,
                                emb_cap=emb_cap)

    def _stages_and_commit(self, frame_id, det_dev, emb_dev, costs,
                           host_emb=None, emb_cap=None):
        (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
         base_iou_active, base_unconf, u_det, col4row) = costs
        n_depth = (self.max_age + 2) // 2
        new_state, new_hist, info = scan_finals_commit_core(
            self.kf_cfg, n_depth, self.conf_thresh, self.max_reid_cost,
            1.0 - self.duplicate_thresh, self.confirm_hits, self.max_age,
            self.history_size, self.assoc_eps, asg.FORBID,
            cost, iou_cost, depth_masks, base_iou_active, base_unconf,
            u_det, col4row, self._dev_state, self._hist_store, *det_dev,
            emb_dev, int(frame_id), self._frame_rect_dev,
            reid_cost, h_reid_ok, occluded)
        self._dev_state = new_state
        self._hist_store = new_hist
        self._pending.append(('assoc', {'frame_id': frame_id,
                                        'host_emb': host_emb,
                                        'emb_cap': emb_cap}, info))

    # -- deferred host bookkeeping --------------------------------------------

    def sync(self, infos=None, snapshots=False):
        """Apply pending device results (gap frames + associations) to the
        host Track mirrors, in order, after one device-to-host transfer.
        Pass the pending entries' info vectors already fetched (numpy,
        None for marks) as ``infos`` to reuse a larger batched transfer.

        With ``snapshots=True``, returns ``{frame_id: [(trk_id, tlbr)]}``
        of the confirmed+active tracks after each tagged frame's replay."""
        pending, self._pending = self._pending, []
        if not pending:
            return {} if snapshots else None
        if infos is not None:
            return self._replay(pending, infos, snapshots)
        with Profiler('sync'):
            infos = fetch_infos([info for _, _, info in pending])
            with Profiler('sync.replay'):
                return self._replay(pending, infos, snapshots)

    def _replay(self, pending, infos, snapshots):
        result = {} if snapshots else None
        entries = [((kind, meta), flat) for (kind, meta, _), flat
                   in zip(pending, infos)]
        for k, ((kind, meta), flat) in enumerate(entries):
            if kind == 'gap':
                self._apply_gap_info(meta, flat)
            elif kind == 'assoc':
                self._apply_assoc_info(meta, flat)
            # 'mark' entries carry no device work (init frames)
            if snapshots:
                fid = meta.get('frame_id')
                nxt = entries[k + 1][0][1].get('frame_id') \
                    if k + 1 < len(entries) else None
                if fid is not None and fid != nxt:
                    result[fid] = [
                        (t.trk_id, t.tlbr.copy())
                        for t in self.tracks.values()
                        if t.confirmed and t.active]
        return result

    def _apply_gap_info(self, meta, flat):
        slot_ids = meta['slot_ids']
        (h_ok, h_mat, next_tlbrs, lost, has_klt, klt_tlbrs, new_inl,
         bg_prev, bg_cur, bg_inlier, est_ok) = self._unpack_info(flat)
        if not bool(h_ok):
            for trk in self.tracks.values():
                trk.keypoints = np.empty((0, 2), np.float32)
            self.klt_bboxes = {}
            self.homography = None
            LOGGER.warning('Camera motion estimation failed')
            # cleared tracks do NOT enter reID history (tracker.py:160-162)
            self.tracks.clear()
            self._slot_ids = [None] * MAX_TRACKS
            return
        self.homography = h_mat.astype(np.float64)
        keep = bg_inlier.astype(bool)
        self.flow.prev_bg_keypoints = bg_prev[keep]
        self.flow.bg_keypoints = bg_cur[keep]
        self.klt_bboxes = {}
        tl64 = next_tlbrs.astype(np.float64)
        for i, tid in enumerate(slot_ids):
            if tid is None:
                continue
            track = self.tracks.get(tid)
            if track is None:
                continue
            if est_ok[i]:
                self.klt_bboxes[tid] = klt_tlbrs[i].astype(np.float64)
            if has_klt[i]:
                track.inlier_ratio = float(new_inl[i])
            track.update(tl64[i], track.state)
            if lost[i]:
                if track.confirmed:
                    LOGGER.info(f"{'Out:':<14}{track}")
                    # moved to history; the hist slot arrives in the next
                    # association's info (lost_pending save). The slot id
                    # mapping stays until then.
                    self.hist_tracks[tid] = self.tracks.pop(tid)
                    self._trim_hist()
                else:
                    del self.tracks[tid]
                    self._slot_ids[i] = None

    def _assoc_layout(self):
        t, d, h = MAX_TRACKS, MAX_DETS, self._hist_cap
        return [
            ('head', (4,), np.float32),
            ('match_det', (t,), np.int32), ('merge_src', (t,), np.int32),
            ('dup', (t,), bool), ('del_unconf', (t,), bool),
            ('retire_age', (t,), bool), ('out_of_frame', (t,), bool),
            ('hist_dst', (t,), np.int32), ('reinstate_hist', (t,), np.int32),
            ('create_det', (t,), np.int32),
            ('new_ages', (t,), np.int32), ('new_hits', (t,), np.int32),
            ('new_labels', (t,), np.int32), ('new_valid', (t,), bool),
            ('feat_ok', (t,), bool), ('evict', (h,), bool),
            ('next_tlbrs', (t, 4), np.float32),
            ('means', (t, 8), np.float32), ('covs', (t, 8, 8), np.float32),
        ]

    def _unpack_assoc(self, flat):
        out = {}
        off = 0
        for name, shape, dtype in self._assoc_layout():
            n = int(np.prod(shape))
            arr = flat[off:off + n].reshape(shape)
            off += n
            if dtype is bool:
                arr = arr > 0.5
            elif dtype is not np.float32:
                arr = np.rint(arr).astype(dtype)
            out[name] = arr
        assert off == flat.size, (off, flat.size)
        return out

    def _apply_assoc_info(self, meta, flat):
        """Replay the device's association decisions onto the host Track
        mirrors: logging, ID assignment, history id<->slot bookkeeping."""
        frame_id = meta['frame_id']
        host_emb = meta['host_emb']
        a = self._unpack_assoc(flat)
        slot_ids = self._slot_ids
        self.overflow.bump('track_slots_exhausted', int(a['head'][1]))
        self.overflow.bump('hist_slots_stolen', int(a['head'][2]))
        n_dets = int(a['head'][3])
        self._det_count_hint = n_dets
        emb_cap = meta.get('emb_cap')
        if emb_cap is not None and n_dets > emb_cap:
            self.overflow.bump('emb_budget_exceeded', n_dets - emb_cap)
        nt = a['next_tlbrs'].astype(np.float64)

        def state_of(i):
            return (a['means'][i].copy(), a['covs'][i].copy())

        # 1. merges + duplicates (tracker.py:387-401)
        for jslot in range(MAX_TRACKS):
            i = int(a['merge_src'][jslot])
            if i < 0:
                continue
            u_tid, m_tid = slot_ids[i], slot_ids[jslot]
            t_u = self.tracks.get(u_tid)
            t_m = self.tracks.get(m_tid)
            if t_u is None or t_m is None:
                continue
            LOGGER.debug(f"{'Merged:':<14}{u_tid} -> {m_tid}")
            t_m.merge_continuation(t_u)
            del self.tracks[u_tid]
            slot_ids[i] = None
        for i in np.flatnonzero(a['dup']):
            LOGGER.debug(f"{'Duplicate:':<14}{slot_ids[i]}")

        # 2. matched updates (tracker.py:258-272)
        for i in np.flatnonzero(a['match_det'] >= 0):
            tid = slot_ids[i]
            track = self.tracks.get(tid)
            if track is None:
                continue
            det_id = int(a['match_det'][i])
            is_valid = bool(a['feat_ok'][i]) and not a['out_of_frame'][i]
            if track.hits == self.confirm_hits - 1:
                LOGGER.info(f"{'Found:':<14}{track}")
            emb = host_emb[det_id] if host_emb is not None else None
            track.add_detection(frame_id, nt[i], state_of(i), emb,
                                is_valid and emb is not None)
            if is_valid and emb is None:
                track.avg_feat.count += 1   # features live on device
            if a['out_of_frame'][i]:
                if track.confirmed:
                    LOGGER.info(f"{'Out:':<14}{track}")
                    self.hist_tracks[tid] = self.tracks.pop(tid)
                    self._trim_hist()
                else:
                    del self.tracks[tid]
                slot_ids[i] = None

        # 3. unmatched aging / deletion / retirement (tracker.py:274-284)
        for i in np.flatnonzero(a['del_unconf']):
            tid = slot_ids[i]
            track = self.tracks.get(tid)
            if track is None:
                continue
            track.mark_missed()
            LOGGER.debug(f"{'Unconfirmed:':<14}{track}")
            del self.tracks[tid]
            slot_ids[i] = None
        for i in np.flatnonzero(a['retire_age']):
            tid = slot_ids[i]
            track = self.tracks.get(tid)
            if track is None:
                continue
            track.mark_missed()
            LOGGER.info(f"{'Lost:':<14}{track}")
            self.hist_tracks[tid] = self.tracks.pop(tid)
            self._trim_hist()
        # survivors' ages
        for i in range(MAX_TRACKS):
            tid = slot_ids[i]
            track = self.tracks.get(tid) if tid is not None else None
            if track is not None and a['match_det'][i] < 0 and \
                    a['new_valid'][i]:
                track.age = int(a['new_ages'][i])

        # 4. history saves: map hist slots to retired track ids
        for i in np.flatnonzero(a['hist_dst'] >= 0):
            tid = slot_ids[i]
            if tid is None:
                continue
            s = int(a['hist_dst'][i])
            old = self._hist_slot_tid.get(s)
            if old is not None and old != tid:
                self.hist_tracks.pop(old, None)
            self._hist_slot_tid[s] = tid
            if not a['new_valid'][i]:
                slot_ids[i] = None

        # 5. reinstates (tracker.py:249-256)
        for i in np.flatnonzero(a['reinstate_hist'] >= 0):
            s = int(a['reinstate_hist'][i])
            tid = self._hist_slot_tid.pop(s, None)
            track = self.hist_tracks.pop(tid, None) if tid is not None \
                else None
            det_id = int(a['create_det'][i])
            if track is None:
                continue
            LOGGER.info(f"{'Reidentified:':<14}{track}")
            emb = host_emb[det_id] if host_emb is not None else None
            track.reinstate(frame_id, nt[i], state_of(i), emb)
            if emb is None:
                track.avg_feat.count += 1
            self.tracks[tid] = track
            slot_ids[i] = tid

        # 6. new tracks, in detection order for deterministic IDs
        # (tracker.py:286-293)
        creations = [(int(a['create_det'][i]), i)
                     for i in np.flatnonzero(
                         (a['create_det'] >= 0)
                         & (a['reinstate_hist'] < 0))]
        for det_id, i in sorted(creations):
            new_trk = Track(frame_id, nt[i], state_of(i),
                            int(a['new_labels'][i]), self.confirm_hits)
            self.tracks[new_trk.trk_id] = new_trk
            slot_ids[i] = new_trk.trk_id
            LOGGER.debug(f"{'Detected:':<14}{new_trk}")
            if a['out_of_frame'][i]:
                del self.tracks[new_trk.trk_id]
                slot_ids[i] = None

        # 7. history evictions (LRU cap)
        for s in np.flatnonzero(a['evict']):
            tid = self._hist_slot_tid.pop(int(s), None)
            if tid is not None:
                self.hist_tracks.pop(tid, None)

        # 8. drop slot labels for anything no longer live
        for i in range(MAX_TRACKS):
            if not a['new_valid'][i] and slot_ids[i] is not None and \
                    slot_ids[i] not in self.tracks:
                slot_ids[i] = None

    def _trim_hist(self):
        while len(self.hist_tracks) > self.history_size:
            old_id, _ = self.hist_tracks.popitem(last=False)
            for s, tid in list(self._hist_slot_tid.items()):
                if tid == old_id:
                    del self._hist_slot_tid[s]

    def _info_layout(self):
        t = MAX_TRACKS
        bw, bh = self.flow.spec.bg_size
        n_bg = min(fk.BG_KP, (bh // fk.BG_CELL) * (bw // fk.BG_CELL))
        return [
            ('h_ok', (1,), bool), ('h_mat', (3, 3), np.float64),
            ('next_tlbrs', (t, 4), np.float32), ('lost', (t,), bool),
            ('has_klt', (t,), bool), ('klt_tlbrs', (t, 4), np.float32),
            ('new_inl', (t,), np.float32),
            ('bg_prev', (n_bg, 2), np.float32),
            ('bg_cur', (n_bg, 2), np.float32), ('bg_inlier', (n_bg,), bool),
            ('est_ok', (t,), bool),
        ]

    def _unpack_info(self, flat):
        out = []
        off = 0
        for name, shape, dtype in self._info_layout():
            n = int(np.prod(shape))
            arr = flat[off:off + n].reshape(shape)
            off += n
            if dtype is bool:
                arr = arr > 0.5
            elif dtype is not np.float32:
                arr = arr.astype(dtype)
            out.append(arr if name != 'h_ok' else arr[0])
        assert off == flat.size, (off, flat.size)
        return tuple(out)

    # -- state management ----------------------------------------------------

    def _upload_state(self):
        """Build the device state from the host mirrors (cycle start or
        after legacy-path mutations). One batched H2D."""
        self._dev_state = tuple(torch.as_tensor(a, device=self.device)
                                for a in self._host_state_arrays())
        profiler.count('host_syncs', len(self._dev_state))
        self._ensure_hist_store(reset=True)
        self._mirrors_dirty = False

    def _host_state_arrays(self):
        """Compact the host Track mirrors into the padded state arrays
        (the numpy image of the device state tuple). Also rebuilds the
        slot table."""
        # pending infos refer to the pre-upload slot table; flush first
        self.sync()
        k_cap = fk.KP_PER_TRACK
        # compact live tracks into the slot table
        self._slot_ids = [None] * MAX_TRACKS
        self.overflow.bump('tracks_clipped', len(self.tracks) - MAX_TRACKS)
        for i, tid in enumerate(list(self.tracks.keys())[:MAX_TRACKS]):
            self._slot_ids[i] = tid
        means = np.zeros((MAX_TRACKS, 8), np.float32)
        covs = np.tile(np.eye(8, dtype=np.float32), (MAX_TRACKS, 1, 1))
        tlbrs = np.zeros((MAX_TRACKS, 4), np.float32)
        valid = np.zeros(MAX_TRACKS, bool)
        ages = np.zeros(MAX_TRACKS, np.int32)
        hits = np.zeros(MAX_TRACKS, np.int32)
        labels = np.full(MAX_TRACKS, -2, np.int32)
        start_f = np.zeros(MAX_TRACKS, np.int32)
        end_f = np.zeros(MAX_TRACKS, np.int32)
        lost_pending = np.zeros(MAX_TRACKS, bool)
        inl = np.ones(MAX_TRACKS, np.float32)
        kps = np.zeros((MAX_TRACKS, k_cap, 2), np.float32)
        kpv = np.zeros((MAX_TRACKS, k_cap), bool)
        fsum = np.zeros((MAX_TRACKS, FEAT_DIM), np.float32)
        fcnt = np.zeros(MAX_TRACKS, np.float32)
        for i, tid in enumerate(self._slot_ids):
            if tid is None:
                continue
            trk = self.tracks[tid]
            means[i], covs[i] = trk.state
            tlbrs[i] = trk.tlbr
            valid[i] = True
            ages[i] = trk.age
            hits[i] = trk.hits
            labels[i] = trk.label
            start_f[i] = trk.start_frame
            end_f[i] = trk.end_frame
            inl[i] = trk.inlier_ratio
            k = min(len(trk.keypoints), k_cap)
            self.overflow.bump('keypoints_clipped',
                               len(trk.keypoints) - k_cap)
            if k:
                kps[i, :k] = trk.keypoints[:k]
                kpv[i, :k] = True
            if trk.avg_feat.sum is not None:
                fsum[i] = trk.avg_feat.sum
                fcnt[i] = trk.avg_feat.count
        return (means, covs, tlbrs, valid, ages, hits, labels, start_f,
                end_f, lost_pending, inl, kps, kpv, fsum, fcnt)

    def _ensure_hist_store(self, reset=False):
        if self._hist_store is not None and not reset:
            return
        self._hist_store = tuple(torch.as_tensor(a, device=self.device)
                                 for a in self._host_hist_arrays(reset))
        profiler.count('host_syncs', len(self._hist_store))

    def _host_hist_arrays(self, reset=False):
        """Padded numpy image of the device history store; with ``reset``
        the id<->slot map is rebuilt from the host mirrors."""
        h = self._hist_cap
        hist_sum = np.zeros((h, FEAT_DIM), np.float32)
        hist_count = np.zeros(h, np.float32)
        h_labels = np.full(h, -2, np.int32)
        h_valid = np.zeros(h, bool)
        h_lru = np.zeros(h, np.int32)
        h_hits = np.zeros(h, np.int32)
        if reset:
            # rebuild from host mirrors (the features themselves live in
            # the track objects only when the host path supplied them)
            self._hist_slot_tid = {}
            for s, (tid, trk) in enumerate(
                    list(self.hist_tracks.items())[:h]):
                if trk.avg_feat.sum is not None:
                    hist_sum[s] = trk.avg_feat.sum
                hist_count[s] = trk.avg_feat.count
                h_labels[s] = trk.label
                h_valid[s] = True
                h_lru[s] = trk.end_frame
                h_hits[s] = trk.hits
                self._hist_slot_tid[s] = tid
        return (hist_sum, hist_count, h_labels, h_valid, h_lru, h_hits)

    def _invalidate_device_state(self):
        self._dev_state = None

    # -- legacy API-parity paths ----------------------------------------------

    def compute_flow(self, frame):
        """KLT tracklet + camera motion estimation through
        ``Flow.predict`` (the JAX package's API-parity path; ``track`` is
        the scheduler's)."""
        self.sync()
        self._mirrors_dirty = True
        active_tracks = [t for t in self.tracks.values() if t.active]
        self.klt_bboxes, self.homography = self.flow.predict(frame,
                                                             active_tracks)
        if self.homography is None:
            self.tracks.clear()

    def apply_kalman(self):
        """Kalman warp/predict/update of every track from the KLT boxes of
        the last ``compute_flow`` (API-parity path)."""
        self._mirrors_dirty = True
        if not self.tracks:
            return
        trk_ids = list(self.tracks.keys())[:MAX_TRACKS]
        b = MAX_TRACKS
        means = np.zeros((b, 8), np.float32)
        covs = np.tile(np.eye(8, dtype=np.float32), (b, 1, 1))
        klt_tlbrs = np.zeros((b, 4), np.float32)
        has_klt = np.zeros(b, bool)
        mult = np.ones(b, np.float32)
        for i, tid in enumerate(trk_ids):
            trk = self.tracks[tid]
            means[i], covs[i] = trk.state
            if tid in self.klt_bboxes:
                klt_tlbrs[i] = self.klt_bboxes[tid]
                has_klt[i] = True
                mult[i] = max(self.age_penalty * trk.age, 1) / \
                    trk.inlier_ratio
        h_mat = np.eye(3, dtype=np.float32) if self.homography is None \
            else np.asarray(self.homography, dtype=np.float32)
        out = apply_kalman_core(
            self.kf_cfg, *(torch.as_tensor(a, device=self.device)
                           for a in (means, covs, h_mat)),
            self._trans_mat, self._acc_cov,
            *(torch.as_tensor(a, device=self.device)
              for a in (klt_tlbrs, has_klt, mult)),
            self._frame_rect_dev)
        new_means, new_covs, next_tlbrs, ios_vals = (t.cpu().numpy()
                                                     for t in out)
        next_tlbrs = next_tlbrs.astype(np.float64)
        for i, tid in enumerate(trk_ids):
            track = self.tracks[tid]
            track.update(next_tlbrs[i], (new_means[i], new_covs[i]))
            if ios_vals[i] < 0.5:
                if track.confirmed:
                    LOGGER.info(f"{'Out:':<14}{track}")
                    self.hist_tracks[tid] = self.tracks.pop(tid)
                    self._trim_hist()
                else:
                    del self.tracks[tid]

    # -- helpers --------------------------------------------------------------

    def _mark_lost(self, trk_id):
        """Retire a track to the history (confirmed) or drop it."""
        track = self.tracks.pop(trk_id)
        if track.confirmed:
            self.hist_tracks[trk_id] = track
            self._trim_hist()
        self._mirrors_dirty = True

    def _group_tracks_by_depth(self, group_size=2):
        n_depth = (self.max_age + group_size) // group_size
        confirmed_by_depth = [[] for _ in range(n_depth)]
        unconfirmed = []
        for trk_id, track in self.tracks.items():
            if track.confirmed:
                confirmed_by_depth[track.age // group_size].append(trk_id)
            else:
                unconfirmed.append(trk_id)
        return confirmed_by_depth, unconfirmed
