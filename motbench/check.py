"""The correctness check: what the timed path produced at the probed
frames, against the plain reference under ``reference/``.

Each probed association frame is checked stage by stage:

* ``det_heads_rel``: the network's head maps against the float32
  reference network on the same frames and weights: the mean difference
  over the mean reference value, the worst head (``det_heads_off``, the
  share of elements off by more than ``HEAD_OFF`` of it, is printed
  beside it);
* ``det_decode_rel``: the program's decoded rows against the reference
  decode of the program's own heads (the stage that the selection check
  skips, checked by itself);
* ``nms_rows_off``: ``nms_select``'s kept rows against the reference
  selection of the program's own decoded rows: rows whose validity or
  label differ, or whose box is off by more than ``ROW_PX``;
* ``reid_crops_off``: the share of valid crops whose unit embedding lies
  farther than ``REID_OFF`` from the float32 reference crop and OSNet's;
* ``assoc_slots_off``, ``assoc_mean_px``, ``assoc_cov_rel``: the
  association's committed state against the reference association from
  the program's state before it and the same detections and embeddings:
  the share of live slots whose valid flag, age, hits, label, start or
  end frame or flow inlier ratio differ or whose mean is off by more than
  ``MEAN_OFF``; on the others, the 90th percentile of the mean gap and the
  worst covariance's gap over its largest entry.

Each probed gap frame: ``gap_slots_off``, ``gap_mean_px``,
``gap_cov_rel``, the same of the gap frame's committed state against the
reference flow step from the program's state before it and the
reference's own preprocess of the two frames.

The tracker stages, the decode and the selection follow the program's
own state, one step each: a whole reference run would part from the
program at the first tie that rounds the other way and compare nothing
after it. What they start from is checked by itself: the heads against
the reference network, the state before a probed step by the probed
steps before it.

The control (``control=True``): the program's own int8 path (run with
``--control int8``) for ReID's number; the reference network with every
convolution's input and weight through float8 e4m3 (``detect.fp8``) in
the program's place for the detector's heads, since the program's int8
path keeps each activation after a convolution in float32 and reads
closer to the reference than the bf16 network; for the stages that follow
the program's state, the reference itself in the program's place with
its inputs and outputs rounded to bfloat16, the precision below their
float32.
"""
from __future__ import annotations

import torch

ROW_PX = 1e-2        # px: a kept row's box
INL_OFF = 1e-3       # a track slot's inlier ratio (a point is 1 / 32)
MEAN_OFF = 16.0      # px: a track slot's mean
HEAD_OFF = 0.03      # of a head's mean |value|: a head element
REID_OFF = 0.006     # euclidean, unit embeddings: a crop's embedding
DISCRETE = (3, 4, 5, 6, 7, 8)     # valid, ages, hits, labels, start, end


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def rel_gap(got, ref) -> float:
    """Mean |got - ref| over mean |ref|."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().mean() / ref.abs().mean().clamp(min=1e-12))


def state_gaps(got, ref):
    """(the share of live slots off: a discrete field differs, the inlier
    ratio by more than ``INL_OFF`` (the flow's inliers differ) or the mean
    by more than ``MEAN_OFF``; over the slots valid on both sides and not
    off, the 90th percentile of a slot's largest mean gap in px, and the
    worst covariance's gap over its largest reference entry).

    A track's similarity fit is a RANSAC whose best hypothesis can change
    with one rounding: a sound gap frame then moves that track's mean by a
    few pixels (up to 5.3 px over 12 seeds) with the same inliers, so the
    mean gap is a percentile, and the worst slots are held by
    ``MEAN_OFF``."""
    both = got[3] & ref[3]
    off = torch.zeros_like(got[3])
    for i in DISCRETE:
        a, b = got[i], ref[i]
        off |= (a != b).reshape(a.shape[0], a.shape[1], -1).any(-1) \
            if a.dim() > 2 else (a != b)
    mean_gap = (got[0] - ref[0]).abs().amax(-1)
    off |= both & ((got[10] - ref[10]).abs() > INL_OFF)
    off |= both & (mean_gap > MEAN_OFF)
    live = (got[3] | ref[3]).sum().clamp(min=1)
    same = both & ~off
    if not same.any():
        return float(off.sum() / live), 0.0, 0.0
    cov_d = (got[1] - ref[1]).abs().amax((-1, -2))[same]
    cov_r = ref[1].abs().amax((-1, -2))[same].clamp(min=1e-12)
    return (float(off.sum() / live),
            float(mean_gap[same].double().quantile(0.9)),
            float((cov_d / cov_r).max()))


def share_off(got, ref, frac):
    """The share of elements off by more than ``frac`` of the mean |ref|."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() > frac * ref.abs().mean()).double()
                 .mean())


def rows_off(got, ref) -> int:
    g_tlbr, g_lab, g_conf, g_val = got
    r_tlbr, r_lab, r_conf, r_val = ref
    same = (g_val == r_val) & (~r_val | (
        (g_lab == r_lab)
        & ((g_tlbr - r_tlbr).abs().amax(-1) <= ROW_PX)))
    return int((~same).sum())


def bf16(x):
    """``x`` (a tensor, or a tuple of them) with its floats rounded to
    bfloat16."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() \
            else x
    return tuple(bf16(t) for t in x)


class Checker:
    """The reference side of a cell: its detector geometry and networks
    from the configuration, its tracker constants."""

    def __init__(self, cell, det_weights, reid_weights, device):
        from .reference import detect
        from .reference.steps import TrackerParams
        cfg = cell.config
        self.cell, self.device = cell, device
        self.det_cfg, self.reid_cfg = cfg['detector'], cfg['reid']
        self.sections = cell.darknet_sections()
        self.letterbox = detect.Letterbox(
            tuple(cfg['frame_size']), tuple(self.det_cfg['input_hw']),
            self.det_cfg['letterbox'])
        self.det_w = {k: v.to(device, torch.float32)
                      for k, v in det_weights.items()}
        self.reid_w = {k: v.to(device, torch.float32)
                       for k, v in reid_weights.items()}
        self.params = TrackerParams.from_config(
            tuple(cfg['frame_size']), cfg['tracker_cfg'],
            self.reid_cfg['metric'], 1.0 / cfg['frame_rate'])
        ycfg = cfg['yolo_detector_cfg']
        mask = torch.zeros(self.det_cfg['num_classes'], dtype=torch.bool)
        mask[list(cfg['class_ids'])] = True
        self.nms_args = (mask, ycfg.get('conf_thresh', 0.25),
                         ycfg.get('nms_thresh', 0.5),
                         ycfg.get('max_area', 800000),
                         ycfg.get('min_aspect_ratio', 1.2),
                         torch.tensor(self.letterbox.scale_wh),
                         torch.tensor(self.letterbox.offset,
                                      dtype=torch.float32))

    @torch.no_grad()
    def detector(self, frames_u8, rec, control=False):
        from .reference import detect
        dev = self.device
        x = self.letterbox(torch.as_tensor(frames_u8, device=dev))
        heads = [h.cpu() for h in detect.darknet_forward(self.sections,
                                                         self.det_w, x)]
        got = rec['heads'] if not control else [
            h.cpu() for h in detect.darknet_forward(
                self.sections, self.det_w, x, quant=detect.fp8)]
        out = {'det_heads_rel': max(rel_gap(g, r) for g, r in
                                    zip(got, heads)),
               'det_heads_off': max(share_off(g, r, HEAD_OFF) for g, r in
                                    zip(got, heads))}
        anchors = tuple(torch.tensor(a, dtype=torch.float32).reshape(-1, 2)
                        for a in self.det_cfg['anchors'])
        hw = tuple(self.det_cfg['input_hw'])

        def decode(hs):
            return detect.decode_heads(list(hs), anchors,
                                       self.det_cfg['scales'], hw,
                                       self.det_cfg['new_coords'])
        decoded = decode(rec['heads'])
        got = decode(bf16(rec['heads'])) if control else rec['decoded']
        out['det_decode_rel'] = _decode_gap(got, decoded)
        ref_rows = detect.nms_and_gate(rec['decoded'], *self.nms_args)
        got_rows = detect.nms_and_gate(bf16(rec['decoded']), *self.nms_args) \
            if control else rec['nms']
        out['nms_rows_off'] = rows_off(got_rows, ref_rows)
        return out

    @torch.no_grad()
    def reid(self, frames_u8, rec):
        from .reference import reid
        dev = self.device
        tlbr, valid = rec['dets'][0].to(dev), rec['dets'][3]
        x = reid.crops(torch.as_tensor(frames_u8, device=dev), tlbr,
                       tuple(self.reid_cfg['input_hw']))
        ref = []
        for part in x.split(256):
            ref.append(reid.osnet_forward(self.reid_w, part,
                                          self.reid_cfg['channels']).cpu())
        ref = torch.cat(ref).reshape(rec['emb'].shape)
        d = torch.linalg.norm(rec['emb'].double() - ref.double(), dim=-1)
        d = d[valid]
        if not d.numel():
            return {'reid_crops_off': 0.0}
        return {'reid_crops_off': float((d > REID_OFF).double().mean()),
                'reid_emb_gap': float(d.mean()),
                'reid_emb_max': float(d.max())}

    @torch.no_grad()
    def assoc(self, rec, control=False):
        from .reference.steps import assoc_step

        def step(state):
            return assoc_step(self.params, rec['frame_id'], state,
                              rec['hist'], rec['dets'], rec['emb'])[0]
        ref = step(rec['state'])
        got = bf16(step(bf16(rec['state']))) if control else rec['new_state']
        off, mean_px, cov = state_gaps(got, ref)
        return {'assoc_slots_off': off, 'assoc_mean_px': mean_px,
                'assoc_cov_rel': cov}

    @torch.no_grad()
    def gap(self, frames_prev, frames_cur, rec, control=False):
        from .reference import steps
        p = self.params
        prev = steps.preprocess(p, torch.as_tensor(frames_prev))
        cur = steps.preprocess(p, torch.as_tensor(frames_cur))

        def step(state):
            return steps.gap_step(p, state, prev, cur, rec['seeds'])
        ref = step(rec['state'])
        got = bf16(step(bf16(rec['state']))) if control else rec['new_state']
        off, mean_px, cov = state_gaps(got, ref)
        return {'gap_slots_off': off, 'gap_mean_px': mean_px,
                'gap_cov_rel': cov}


def _decode_gap(got, ref) -> float:
    """The worst column's largest gap over its largest reference value;
    rows whose box is not finite on both sides are left out of the box
    columns."""
    worst = 0.0
    for c in range(got.shape[-1]):
        g, r = got[..., c].double(), ref[..., c].double()
        ok = torch.isfinite(g) & torch.isfinite(r)
        if (torch.isfinite(g) != torch.isfinite(r)).any():
            return float('inf')
        if ok.any():
            worst = max(worst, float((g - r)[ok].abs().max()
                                     / r[ok].abs().max().clamp(min=1e-12)))
    return worst


def run_checks(checker, probe, frames_at, control=False):
    """Every number over the probed frames, the worst of each.
    ``frames_at(f)``: the host frames [S, H, W, 3] of frame ``f``."""
    worst = {}

    def keep(d):
        for k, v in d.items():
            worst[k] = max(worst.get(k, 0.0), v)
    for f, rec in sorted(probe.assoc.items()):
        keep(checker.detector(frames_at(f), rec, control))
        keep(checker.reid(frames_at(f), rec))
        keep(checker.assoc(rec, control))
    for f, rec in sorted(probe.gap.items()):
        keep(checker.gap(frames_at(f - 1), frames_at(f), rec, control))
    return worst
