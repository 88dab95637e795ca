"""MOT-Challenge metrics: CLEAR-MOT (MOTA/MOTP/FP/FN/IDSW/MT/ML) and IDF1.

The reference computes tracking metrics with the external TrackEval repo
(README.md:42, eval/seqmap.txt); this module makes the evaluation a
built-in capability so MOT20/MOT17 parity runs need no extra tooling.

Conventions follow the MOT Challenge evaluation protocol:
  * frame-by-frame correspondence at IoU >= 0.5, preferring to keep the
    previous frame's matches (CLEAR continuity rule), Hungarian on the
    remainder;
  * MOTA = 1 - (FN + FP + IDSW) / num_gt;
  * MOTP here reported as mean IoU of matches (TrackEval's MOTP);
  * IDF1 from the optimal global trajectory bipartite matching
    (Ristani et al. 2016);
  * MT/ML: gt trajectories covered >= 80% / <= 20%.

File format: ``frame,id,x,y,w,h,conf,...`` (1-based frames, tlwh pixels),
the same rows app.py writes (app.py:92-97). GT rows with class labels use
the MOT17/20 convention: only consider class 1 (pedestrian) and flagged
(col 7 == 1) entries when present.

At-home cross-check against TrackEval (the reference's methodology,
README.md:42) — results must agree on MOTA/IDF1 to rounding::

    git clone https://github.com/JonathonLuiten/TrackEval
    python TrackEval/scripts/run_mot_challenge.py \
        --BENCHMARK MOT20 --SPLIT_TO_EVAL train \
        --TRACKERS_TO_EVAL fastmot_tpu --METRICS CLEAR Identity \
        --GT_FOLDER <mot20>/train --TRACKERS_FOLDER <results>
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclasses.dataclass
class MotMetrics:
    mota: float
    motp: float
    idf1: float
    num_gt: int
    fp: int
    fn: int
    idsw: int
    mt: int
    ml: int
    num_frames: int

    def __str__(self):
        return (f'MOTA {self.mota * 100:.1f}%  IDF1 {self.idf1 * 100:.1f}%  '
                f'MOTP {self.motp * 100:.1f}%  FP {self.fp}  FN {self.fn}  '
                f'IDSW {self.idsw}  MT {self.mt}  ML {self.ml}')


def load_mot(path_or_array, gt: bool = False):
    """Load a MOT txt file (or array) into {frame: (ids, tlwh boxes)}."""
    if isinstance(path_or_array, np.ndarray):
        data = path_or_array
    else:
        data = np.loadtxt(path_or_array, delimiter=',', ndmin=2)
    frames = defaultdict(lambda: ([], []))
    if data.size == 0:
        return frames
    for row in data:
        if gt and data.shape[1] >= 8:
            # gt.txt: frame,id,x,y,w,h,flag,class,visibility
            if row[6] == 0:
                continue
            if data.shape[1] >= 8 and row[7] not in (1, -1):
                continue
        f = int(row[0])
        frames[f][0].append(int(row[1]))
        frames[f][1].append(row[2:6].astype(float))
    return frames


def _iou_matrix_tlwh(a, b):
    """Pairwise IoU of tlwh boxes (MOT convention: w,h are extents)."""
    a = np.asarray(a, float).reshape(-1, 4)
    b = np.asarray(b, float).reshape(-1, 4)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, :2] + a[:, None, 2:],
                    b[None, :, :2] + b[None, :, 2:])
    wh = np.maximum(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None, :]
    union = area_a + area_b - inter
    with np.errstate(divide='ignore', invalid='ignore'):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def evaluate(gt_frames, res_frames, iou_thresh: float = 0.5) -> MotMetrics:
    """Run CLEAR-MOT + IDF1 over {frame: (ids, boxes)} dicts."""
    all_frames = sorted(set(gt_frames) | set(res_frames))
    num_gt = 0
    fp = fn = idsw = 0
    iou_sum = 0.0
    num_matches = 0
    last_match: dict[int, int] = {}          # gt_id -> res_id
    gt_frames_per_traj = defaultdict(int)
    matched_frames_per_traj = defaultdict(int)

    # frame-level co-occurrence counts for IDF1 (Ristani et al. 2016 /
    # TrackEval's potential_matches): every (gt, res) pair with
    # IoU >= thresh in a frame counts, INDEPENDENT of which pairs the
    # CLEAR matcher selected that frame — ID measures are defined over
    # the global trajectory bipartite, not over CLEAR continuity
    pair_overlap = defaultdict(int)          # (gt_id, res_id) -> frames
    gt_total = defaultdict(int)
    res_total = defaultdict(int)

    for f in all_frames:
        g_ids, g_boxes = gt_frames.get(f, ([], []))
        r_ids, r_boxes = res_frames.get(f, ([], []))
        num_gt += len(g_ids)
        for gid in g_ids:
            gt_frames_per_traj[gid] += 1
            gt_total[gid] += 1
        for rid in r_ids:
            res_total[rid] += 1

        if not g_ids and not r_ids:
            continue
        if not g_ids:
            fp += len(r_ids)
            continue
        if not r_ids:
            fn += len(g_ids)
            continue

        iou = _iou_matrix_tlwh(g_boxes, r_boxes)
        valid = iou >= iou_thresh
        for gi, rj in zip(*np.nonzero(valid)):
            pair_overlap[(g_ids[gi], r_ids[rj])] += 1

        matches = {}
        # CLEAR continuity: keep last frame's correspondence when valid
        used_r = set()
        for gi, gid in enumerate(g_ids):
            rid_prev = last_match.get(gid)
            if rid_prev is not None and rid_prev in r_ids:
                rj = r_ids.index(rid_prev)
                if valid[gi, rj] and rj not in used_r:
                    matches[gi] = rj
                    used_r.add(rj)
        # Hungarian on the rest, maximizing IoU
        rem_g = [gi for gi in range(len(g_ids)) if gi not in matches]
        rem_r = [rj for rj in range(len(r_ids)) if rj not in used_r]
        if rem_g and rem_r:
            sub = iou[np.ix_(rem_g, rem_r)]
            cost = np.where(sub >= iou_thresh, 1.0 - sub, 1e6)
            ri, ci = linear_sum_assignment(cost)
            for i, j in zip(ri, ci):
                if cost[i, j] < 1e6:
                    matches[rem_g[i]] = rem_r[j]

        for gi, rj in matches.items():
            gid, rid = g_ids[gi], r_ids[rj]
            if gid in last_match and last_match[gid] != rid:
                idsw += 1
            last_match[gid] = rid
            iou_sum += iou[gi, rj]
            num_matches += 1
            matched_frames_per_traj[gid] += 1

        fn += len(g_ids) - len(matches)
        fp += len(r_ids) - len(matches)

    # ---- IDF1: optimal trajectory-level bipartite matching ----------------
    gt_ids = sorted(gt_total)
    res_ids = sorted(res_total)
    idtp = 0
    if gt_ids and res_ids:
        overlap = np.zeros((len(gt_ids), len(res_ids)))
        for (gid, rid), c in pair_overlap.items():
            overlap[gt_ids.index(gid), res_ids.index(rid)] = c
        ri, ci = linear_sum_assignment(-overlap)
        idtp = int(overlap[ri, ci].sum())
    sum_gt = sum(gt_total.values())
    sum_res = sum(res_total.values())
    idfn = sum_gt - idtp
    idfp = sum_res - idtp
    idf1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)

    mt = ml = 0
    for gid, total in gt_frames_per_traj.items():
        ratio = matched_frames_per_traj[gid] / total
        if ratio >= 0.8:
            mt += 1
        elif ratio <= 0.2:
            ml += 1

    mota = 1.0 - (fn + fp + idsw) / max(num_gt, 1)
    motp = iou_sum / max(num_matches, 1)
    return MotMetrics(mota=mota, motp=motp, idf1=idf1, num_gt=num_gt,
                      fp=fp, fn=fn, idsw=idsw, mt=mt, ml=ml,
                      num_frames=len(all_frames))


def evaluate_files(gt_path, res_path, iou_thresh: float = 0.5) -> MotMetrics:
    return evaluate(load_mot(gt_path, gt=True), load_mot(res_path),
                    iou_thresh)


def main():
    import argparse
    p = argparse.ArgumentParser(description='MOT Challenge evaluation')
    p.add_argument('--gt', required=True, help='path to gt.txt')
    p.add_argument('--res', required=True, help='path to result txt')
    p.add_argument('--iou', type=float, default=0.5)
    args = p.parse_args()
    print(evaluate_files(args.gt, args.res, args.iou))


if __name__ == '__main__':
    main()
