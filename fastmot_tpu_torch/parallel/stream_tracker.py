"""Stream-axis tracker: S streams' tracking state in one [S, ...] state
(port of ``fastmot_tpu/parallel/stream_tracker.py``).

``StreamTracker`` holds ONE device state with a leading stream axis and
runs each frame's work once for all streams: the flow preprocess, the
point assembly, LK and the gap commit of a gap frame; the costs, the
cascade stages, the greedy finals and the commit of an association frame
(``tracker.*_batch``, ``tracker.stages_scan_core``,
``tracker.finals_core``).
The per-stream ``MultiTracker`` host shells are presentation mirrors:
``sync`` fetches every stream's info vectors in one transfer and replays
them, stream by stream, through ``MultiTracker.sync(infos=...)``.

Kept from the JAX package: the densest stream picks the flow budget
``f_cap`` of all streams; every stream's RANSAC seed starts at 0 at
``init`` and goes up by one per gap frame, and its draws come from its own
seed; the pending infos replay stream-major at ``sync`` (``Track._count``
is global, so the order sets the IDs).

With ``mesh`` (``parallel.make_stream_mesh``) this rank owns the
contiguous block of streams given by its coordinate on ``'streams'`` (the
streams split evenly over that axis) and holds only their state; the ranks on
``'model'`` of one block hold the same replicated state. Every method then
takes and returns this rank's streams only, and the ranks call them in
lockstep. Two things cross the ``'streams'`` axis so that the sharded run
gives the unsharded one's numbers: one ``all_reduce(MAX)`` of the densest
stream's track count per gap frame (the flow budget, which sets every
stream's RANSAC draws), and at ``init`` and ``sync`` one ``all_gather`` of
each stream's count of new tracks, from which each rank starts its ID
counter at the stream-major offset of its first stream (each process has
its own ``Track._count``).
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from .. import kalman as kf
from ..device import torch_device
from ..ops import flow_kernels as fk
from ..track import Track
from ..tracker import (MAX_DETS, MAX_TRACKS, MultiTracker,
                       assoc_costs_batch, commit_batch, fetch_infos,
                       finals_core, gap_commit_batch, gap_points_batch,
                       stages_scan_core)
from .streams import axis_size

__all__ = ['StreamTracker']

LOGGER = logging.getLogger(__name__)


class StreamTracker:
    """S logical trackers sharing one [S, ...] device state.

    Public surface: ``init / track / update_device / sync / reset /
    visible_tracks`` plus the per-stream host mirrors ``trackers[s]``
    (Track dicts, IDs, logging: the presentation shell of
    ``MultiTracker``). With ``mesh``, ``trackers`` holds this rank's
    streams, ``local_streams`` their global indices."""

    def __init__(self, size, metric, n_streams, device='cuda', mesh=None,
                 **tracker_cfg):
        assert n_streams >= 1
        self.n_streams = n_streams
        self.device = torch_device(device)
        self.mesh = mesh
        self._group = None
        lo, n_local = 0, n_streams
        if mesh is not None:
            blocks = axis_size(mesh, 'streams')
            if n_streams % blocks:
                raise ValueError(f'{n_streams} streams do not split over '
                                 f'{blocks} stream blocks')
            n_local = n_streams // blocks
            lo = mesh.get_local_rank('streams') * n_local
            self._group = mesh.get_group('streams')
        self.local_streams = range(lo, lo + n_local)
        self.trackers = [MultiTracker(size, metric, device=self.device,
                                      **tracker_cfg)
                         for _ in range(n_local)]
        self.kf_cfg = self.trackers[0].kf_cfg
        self._dev_state = None        # [S, ...] state tuple
        self._hist_store = None       # [S, H, ...]
        self._prev_pre = None         # flow state of the last frames
        self._seeds = None            # each stream's RANSAC seed

    # -- helpers -------------------------------------------------------------

    def _put(self, arrays):
        return tuple(torch.as_tensor(np.stack(a), device=self.device)
                     for a in zip(*arrays))

    def _stack_from_mirrors(self):
        """Stack every stream's host state arrays into one upload."""
        self.sync()
        self._dev_state = self._put([trk._host_state_arrays()
                                     for trk in self.trackers])
        self._hist_store = self._put([trk._host_hist_arrays(reset=True)
                                      for trk in self.trackers])
        for trk in self.trackers:
            trk._mirrors_dirty = False
            trk._dev_state = None      # the stacked state is authoritative

    def _collective(self, values):
        """``values`` (ints) of every stream block, in block order: one
        ``all_gather`` over ``'streams'`` on the mesh's device."""
        t = torch.tensor(values, dtype=torch.int64,
                         device=self.mesh.device_type)
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self._group))]
        dist.all_gather(parts, t, group=self._group)
        return torch.stack(parts).cpu().tolist()

    def _claim_ids(self, counts):
        """Before this rank creates ``counts[i]`` tracks on its i-th stream:
        start ``Track._count`` at the stream-major offset of its first
        stream; returns the count after every stream's new tracks."""
        if self.mesh is None:
            return None
        blocks = self._collective([Track._count, *counts])
        base = blocks[0][0]            # the first block's counter
        me = self.mesh.get_local_rank('streams')
        Track._count = base + sum(sum(b[1:]) for b in blocks[:me])
        return base + sum(sum(b[1:]) for b in blocks)

    def _preprocess(self, frames):
        return fk.preprocess(self.trackers[0].flow.spec, frames)

    @property
    def _dirty(self):
        return self._dev_state is None or any(
            t._mirrors_dirty for t in self.trackers)

    # -- lifecycle ------------------------------------------------------------

    def reset(self, cap_dt):
        for trk in self.trackers:
            trk.reset(cap_dt)
        self._dev_state = None
        self._hist_store = None
        self._prev_pre = None

    def init(self, frames, detections_per_stream):
        """First frame: per-stream host init, one stacked upload.
        ``frames``: [S, H, W, 3] uint8 BGR (device tensor or host
        array)."""
        frames = torch.as_tensor(frames, device=self.device)
        end = self._claim_ids([min(len(d), MAX_DETS)
                               for d in detections_per_stream])
        for trk, dets in zip(self.trackers, detections_per_stream):
            trk._pending = []
            trk.tracks.clear()
            trk._slot_ids = [None] * MAX_TRACKS
            self._init_stream_tracks(trk, dets)
        if end is not None:
            Track._count = end
        self._stack_from_mirrors()
        self._prev_pre = self._preprocess(frames)
        self._seeds = [0] * len(self.trackers)

    @staticmethod
    def _init_stream_tracks(trk, detections):
        """Host-side first-frame track creation of ``MultiTracker.init``,
        without its own device upload."""
        n = min(len(detections), MAX_DETS)
        trk.overflow.bump('detections_clipped', len(detections) - MAX_DETS)
        if n:
            tlbrs = np.zeros((MAX_DETS, 4), np.float32)
            tlbrs[:n] = detections.tlbr[:n]
            means, covs = (t.cpu().numpy() for t in kf.create(
                trk.kf_cfg, torch.as_tensor(tlbrs, device=trk.device)))
            for i, det in enumerate(detections[:n]):
                new_trk = Track(0, det.tlbr, (means[i], covs[i]), det.label,
                                trk.confirm_hits)
                trk.tracks[new_trk.trk_id] = new_trk
                trk._slot_ids[i] = new_trk.trk_id
                LOGGER.debug(f"{'Detected:':<14}{new_trk}")
        trk._mirrors_dirty = True

    # -- frame paths ----------------------------------------------------------

    @torch.no_grad()
    def track(self, frames, frame_id=None):
        """Tracking-only frame for ALL streams. ``frames``: [S, H, W, 3]
        uint8 BGR."""
        frames = torch.as_tensor(frames, device=self.device)
        if self._prev_pre is None:
            self._prev_pre = self._preprocess(frames)
            self._seeds = [0] * len(self.trackers)
            return
        if self._dirty:
            self._stack_from_mirrors()
        t0 = self.trackers[0]
        max_active = 0
        for trk in self.trackers:
            n_active = sum(1 for t in trk.tracks.values() if t.active)
            max_active = max(max_active, n_active)
            trk.overflow.bump('flow_tracks_clipped',
                              n_active - fk.MAX_FLOW_TRACKS)
        if self.mesh is not None:
            t = torch.tensor(max_active, device=self.mesh.device_type)
            dist.all_reduce(t, dist.ReduceOp.MAX, group=self._group)
            max_active = int(t)
        # one budget for the whole batch: the densest stream picks
        f_cap = fk.flow_budget(max_active)

        spec = t0.flow.spec
        prev = self._prev_pre
        cur = self._preprocess(frames)
        all_prev, all_valid, inside, forder, f_tlbrs, f_valid = \
            gap_points_batch(spec, f_cap, self._dev_state, prev)
        all_cur, status = fk.lk_core(spec, prev[1], cur[1], all_prev,
                                     all_valid)
        # each stream's draws from its own seed, uploaded together
        draws = [fk.ransac_draws(seed, f_cap, 'cpu') for seed in self._seeds]
        draws = tuple(torch.stack(u).to(self.device) for u in zip(*draws))
        new_state, infos = gap_commit_batch(
            self.kf_cfg, spec, float(t0.age_penalty), t0.confirm_hits,
            self._dev_state, inside, f_tlbrs, f_valid, forder, all_prev,
            all_cur, status, draws, t0._trans_mat, t0._acc_cov,
            t0._frame_rect_dev)
        self._dev_state = new_state
        self._prev_pre = cur
        self._seeds = [seed + 1 for seed in self._seeds]
        for s, trk in enumerate(self.trackers):
            trk._pending.append(('gap', {'slot_ids': list(trk._slot_ids),
                                         'frame_id': frame_id}, infos[s]))

    @torch.no_grad()
    def update_device(self, frame_id, det_batch, emb_batch):
        """Association frame for ALL streams, no host read of the results.

        ``det_batch``: (tlbr [S, D, 4], label [S, D], conf [S, D], valid
        [S, D]); ``emb_batch``: [S, D, F]."""
        if self._dirty:
            self._stack_from_mirrors()
        t0 = self.trackers[0]
        n_depth = (t0.max_age + 2) // 2
        st = self._dev_state
        (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
         base_iou_active, base_unconf, u_det, col4row) = assoc_costs_batch(
            t0._assoc_params(), st, self._hist_store, det_batch, emb_batch)
        u_det, col4row = stages_scan_core(
            n_depth, cost, iou_cost, depth_masks, base_iou_active,
            base_unconf, u_det, col4row, eps=t0.assoc_eps)
        u_det_conf, reid_c4r, rect_c4r = finals_core(
            t0.conf_thresh, t0.max_reid_cost, 1.0 - t0.duplicate_thresh,
            t0.confirm_hits, st[2], st[3], st[4], st[5], det_batch[0],
            det_batch[2], reid_cost, h_reid_ok, occluded, u_det, col4row)
        cascade_out = (occluded, col4row, u_det_conf, reid_c4r, rect_c4r)
        new_state, new_hist, infos = commit_batch(
            self.kf_cfg, t0.confirm_hits, t0.max_age, t0.history_size, st,
            self._hist_store, det_batch, emb_batch, int(frame_id),
            t0._frame_rect_dev, cascade_out)
        self._dev_state = new_state
        self._hist_store = new_hist
        for s, trk in enumerate(self.trackers):
            trk._pending.append(('assoc', {'frame_id': frame_id,
                                           'host_emb': None}, infos[s]))

    # -- deferred host bookkeeping --------------------------------------------

    def sync(self):
        """ONE transfer of every stream's pending infos, then their replay
        through the per-stream mirrors, stream-major."""
        all_infos = [info for trk in self.trackers
                     for (_, _, info) in trk._pending]
        if not all_infos:
            return
        fetched = fetch_infos(all_infos)
        per_stream, off = [], 0
        for trk in self.trackers:
            n = len(trk._pending)
            per_stream.append(fetched[off:off + n])
            off += n
        end = self._claim_ids([
            self._new_tracks(trk, infos)
            for trk, infos in zip(self.trackers, per_stream)]) \
            if self.mesh is not None else None
        for trk, infos in zip(self.trackers, per_stream):
            trk.sync(infos=infos)
        if end is not None:
            Track._count = end

    @staticmethod
    def _new_tracks(trk, infos):
        """How many tracks the replay of ``infos`` creates on ``trk``."""
        n = 0
        for (kind, _, _), flat in zip(trk._pending, infos):
            if kind == 'assoc':
                a = trk._unpack_assoc(flat)
                n += int(np.sum((a['create_det'] >= 0)
                                & (a['reinstate_hist'] < 0)))
        return n

    def visible_tracks(self, stream: int):
        """Confirmed, active tracks of global stream ``stream``; with a mesh
        it must be one of this rank's ``local_streams``."""
        if self.mesh is not None and stream not in self.local_streams:
            n_local = len(self.local_streams)
            owners = self.mesh.mesh[stream // n_local].tolist()
            raise ValueError(f'stream {stream} is tracked on rank(s) '
                             f'{owners}, not on rank {self.mesh.get_rank()}')
        self.sync()
        return (t for t in self.trackers[stream - self.local_streams.start]
                .tracks.values() if t.confirmed and t.active)
