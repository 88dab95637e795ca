"""The port's capacity-overflow counters against the JAX package's: each
case of tests/test_overflow.py on the same seeded inputs through both
packages, the counts equal (the JAX side is the reference the port is held
to, so its values are read, not written down); plus ``StreamTracker``'s
``detections_clipped`` and ``flow_tracks_clipped``."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu import tracker as jtr
from fastmot_tpu.detector import make_detections as jax_detections
from fastmot_tpu.ops import flow_kernels as jfk
from fastmot_tpu.parallel.stream_tracker import \
    StreamTracker as JaxStreamTracker
from fastmot_tpu.track import Track as JaxTrack
from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.detector import make_detections
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.parallel import StreamTracker
from fastmot_tpu_torch.track import Track

from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

SIZE = (160, 120)
FLOW_CFG = {'opt_flow_params': {'winSize': (5, 5), 'maxLevel': 2,
                                'criteria': (3, 10, 0.03)}}


def _tlbrs(n, rng, wh=(10, 14)):
    tl = rng.uniform([0, 0], [SIZE[0] - wh[0] - 1, SIZE[1] - wh[1] - 1],
                     (n, 2))
    return np.concatenate([tl, tl + wh], axis=1)


def _pair(rng):
    """The JAX package's and the port's tracker of tests/test_overflow.py."""
    kw = dict(confirm_hits=1, flow_cfg=FLOW_CFG)
    return (jtr.MultiTracker(SIZE, 'euclidean', **kw),
            ttr.MultiTracker(SIZE, 'euclidean', device='cpu', **kw))


def _init_both(rng, n):
    jt, tt = _pair(rng)
    frame = rng.integers(0, 255, (SIZE[1], SIZE[0], 3), np.uint8)
    tlbrs = _tlbrs(n, rng)
    jt.init(frame, jax_detections(tlbrs, np.ones(n, int), np.full(n, 0.9)))
    tt.init(torch.as_tensor(frame), make_detections(
        tlbrs, np.ones(n, int), np.full(n, 0.9)))
    return jt, tt


def test_detections_clipped(rng):
    jt, tt = _init_both(rng, ttr.MAX_DETS + 25)
    assert tt.overflow == jt.overflow
    assert tt.overflow['detections_clipped'] == 25


def test_flow_budget_covers_mot20_density(rng):
    assert tfk.MAX_FLOW_TRACKS == jfk.MAX_FLOW_TRACKS >= ttr.MAX_TRACKS
    for n in range(0, ttr.MAX_TRACKS + 1):
        assert tfk.flow_budget(n) == jfk.flow_budget(n)
    jt, tt = _init_both(rng, 80)
    assert len(tt.tracks) == len(jt.tracks) == 80
    frame = rng.integers(0, 255, (SIZE[1], SIZE[0], 3), np.uint8)
    jt.track(frame)
    jt.sync()
    tt.track(torch.as_tensor(frame))
    tt.sync()
    assert tt.overflow == jt.overflow
    assert 'flow_tracks_clipped' not in tt.overflow


def test_keypoints_clipped(rng):
    jt, tt = _init_both(rng, 3)
    for trk in (jt, tt):
        tid = next(iter(trk.tracks))
        trk.tracks[tid].keypoints = np.zeros((tfk.KP_PER_TRACK + 7, 2),
                                             np.float32)
        trk._mirrors_dirty = True
        trk._upload_state()
    assert tt.overflow == jt.overflow
    assert tt.overflow['keypoints_clipped'] == 7


def test_tracks_clipped_on_upload(rng):
    jt, tt = _init_both(rng, 5)
    state = (np.zeros(8, np.float32), np.eye(8, dtype=np.float32))
    for trk, cls in ((jt, JaxTrack), (tt, Track)):
        for _ in range(ttr.MAX_TRACKS):
            t = cls(0, np.array([1.0, 1.0, 9.0, 9.0]), state, 1, 1)
            trk.tracks[t.trk_id] = t
        trk._mirrors_dirty = True
        trk._upload_state()
    assert tt.overflow == jt.overflow
    assert tt.overflow['tracks_clipped'] == 5


def test_hist_slot_steal_counted():
    """No detections: the lone confirmed track ages out and saves into a
    FULL history store, a steal the info head reports."""
    from fastmot_tpu.kalman import KalmanConfig as JaxKalmanConfig
    from fastmot_tpu.ops.distance import Metric as JaxMetric
    from fastmot_tpu_torch.kalman import KalmanConfig
    from fastmot_tpu_torch.ops import assignment as asg
    from fastmot_tpu_torch.ops.distance import Metric

    T, D, H, F = 8, 8, 4, 16
    tlbrs = np.tile(np.array([10.0, 10.0, 40.0, 80.0], np.float32), (T, 1))
    state = (np.concatenate([tlbrs, np.zeros((T, 4), np.float32)], 1),
             np.tile(np.eye(8, dtype=np.float32) * 4.0, (T, 1, 1)), tlbrs,
             np.arange(T) < 1, np.full(T, 6, np.int32),
             np.full(T, 3, np.int32), np.ones(T, np.int32),
             np.zeros(T, np.int32), np.zeros(T, np.int32),
             np.zeros(T, bool), np.ones(T, np.float32),
             np.zeros((T, 4, 2), np.float32), np.zeros((T, 4), bool),
             np.ones((T, F), np.float32), np.full(T, 3.0, np.float32))
    hist = (np.ones((H, F), np.float32), np.full(H, 3.0, np.float32),
            np.full(H, 7, np.int32), np.ones(H, bool),
            np.zeros(H, np.int32), np.full(H, 3, np.int32))
    dets = (np.zeros((D, 4), np.float32), np.full(D, -1, np.int32),
            np.zeros(D, np.float32), np.zeros(D, bool),
            np.zeros((D, F), np.float32))
    rect = np.array([0.0, 0.0, 639.0, 479.0], np.float32)
    _, _, jinfo = jtr._assoc_kernel(
        JaxKalmanConfig(), JaxMetric.EUCLIDEAN, 4, 0.2, 0.9, 0.6, 1.0, 0.7,
        0.5, 0.45, 0.2, 1, 6, H, tuple(map(jnp.asarray, state)),
        tuple(map(jnp.asarray, hist)), *map(jnp.asarray, dets),
        jnp.int32(10), jnp.asarray(rect))

    t = torch.as_tensor
    cfg = KalmanConfig()
    st, hs, dt = (tuple(map(t, x)) for x in (state, hist, dets))
    costs = ttr.assoc_costs_core(cfg, Metric.EUCLIDEAN, 4, 0.2, 0.9, 0.6,
                                 1.0, 0.7, 1, st, hs, *dt)
    (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
     base_iou_active, base_unconf, u_det, col4row) = costs
    _, _, info = ttr.scan_finals_commit_core(
        cfg, 4, 0.5, 0.45, 0.2, 1, 6, H, 1e-2, asg.FORBID, cost, iou_cost,
        depth_masks, base_iou_active, base_unconf, u_det, col4row, st, hs,
        *dt, 10, t(rect), reid_cost, h_reid_ok, occluded)
    assert int(info[2]) == int(np.asarray(jinfo)[2]) == 1


def test_overflow_warns_once(caplog):
    counts = []
    for cls, logger in ((jtr.OverflowCounters, 'fastmot_tpu.tracker'),
                        (ttr.OverflowCounters, 'fastmot_tpu_torch.tracker')):
        caplog.clear()
        ov = cls()
        with caplog.at_level(logging.WARNING, logger=logger):
            ov.bump('detections_clipped', 3)
            ov.bump('detections_clipped', 4)
            ov.bump('detections_clipped', 0)
        warns = [r for r in caplog.records
                 if 'Capacity overflow' in r.message]
        assert len(warns) == 1
        counts.append(dict(ov))
    assert counts[0] == counts[1] == {'detections_clipped': 7}


def test_stream_tracker_counters(rng):
    """Stream 0 gets MAX_DETS + 25 detections at init (clipped), stream 1
    five tracks beyond the flow capacity before a gap frame; each stream's
    counters equal the JAX StreamTracker's."""
    frames = rng.integers(0, 255, (2, 2, SIZE[1], SIZE[0], 3), np.uint8)
    n = (ttr.MAX_DETS + 25, 6)
    tlbrs = [_tlbrs(k, rng) for k in n]
    state = (np.zeros(8, np.float32), np.eye(8, dtype=np.float32) * 4.0)
    out = []
    for st, det, cls, put in (
            (JaxStreamTracker(SIZE, 'euclidean', 2, confirm_hits=1,
                              flow_cfg=FLOW_CFG), jax_detections, JaxTrack,
             jnp.asarray),
            (StreamTracker(SIZE, 'euclidean', 2, device='cpu',
                           confirm_hits=1, flow_cfg=FLOW_CFG),
             make_detections, Track, torch.as_tensor)):
        st.reset(1 / 30.0)
        st.init(put(frames[0]), [det(b, np.ones(len(b), int),
                                     np.full(len(b), 0.9)) for b in tlbrs])
        trk = st.trackers[1]
        for _ in range(tfk.MAX_FLOW_TRACKS - n[1] + 5):
            t = cls(0, np.array([100.0, 50.0, 112.0, 70.0]), state, 1, 1)
            trk.tracks[t.trk_id] = t
        trk._mirrors_dirty = True
        st.track(put(frames[1]))
        st.sync()
        out.append([dict(t.overflow) for t in st.trackers])
    assert out[1] == out[0]
    assert out[1][0]['detections_clipped'] == 25
    assert out[1][1]['flow_tracks_clipped'] == 5
