"""Per-stream gap-frame and association-frame cores (``fastmot_tpu_torch/tracker.py``).

Frozen copy of the plain (CPU) version in the port at the commit
that added the benchmark, with the kernel dispatch taken out; it
imports nothing of the port, so later changes to the port cannot
move the yardstick.
"""
from __future__ import annotations

import torch

from . import assignment as asg
from . import distance as dist
from . import flow as fk
from . import geometry as geom
from . import kalman as kf
from .kalman import KalmanConfig


MAX_TRACKS = 128


MAX_DETS = 128


# device state tuple layout (per track slot)
#  0 means [T,8]   1 covs [T,8,8]  2 tlbrs [T,4]   3 valid [T]
#  4 ages [T]      5 hits [T]      6 labels [T]    7 start_f [T]
#  8 end_f [T]     9 lost_pending [T] (confirmed track lost in a gap
#                     frame; its features await a history save)
# 10 inl [T]      11 kps [T,K,2]  12 kpv [T,K]
# 13 feat_sum [T,F]  14 feat_count [T]
N_STATE = 15


# history store tuple layout (per history slot)
#  0 hist_sum [H,F]  1 hist_count [H]  2 h_labels [H]  3 h_valid [H]
#  4 h_lru [H] (insertion frame stamp)  5 h_hits [H]
N_HIST = 6


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


def _flat_info(*arrays) -> torch.Tensor:
    return torch.cat([torch.as_tensor(a).to(torch.float32).reshape(-1)
                      for a in arrays])


def gap_points_core(spec, state, prev_state, f_cap: int):
    """Depth sort (near first) + corner management + LK point assembly
    over the first ``f_cap`` active tracks: the plain version of
    ``ops.gap_points.gap_points`` for one stream."""
    tlbrs, valid, ages, kps, kp_valid = (state[i] for i in (2, 3, 4, 11, 12))
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


def normalized_feats(feat_sum, feat_count):
    avg = feat_sum / torch.clamp(feat_count, min=1.0)[:, None]
    norm = torch.linalg.norm(avg, dim=1, keepdim=True)
    return avg / torch.where(norm > 0, norm, torch.ones_like(norm))


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
