"""The port's legacy per-track API against the JAX package's:
``KalmanFilter`` (seven methods), ``Flow.predict`` with the JAX package's
RANSAC draws, and ``MultiTracker.compute_flow`` + ``apply_kalman`` over
four frames."""
import numpy as np
import pytest
import torch

from fastmot_tpu import KalmanFilter as JaxKalmanFilter
from fastmot_tpu.detector import make_detections as jax_detections
from fastmot_tpu.flow import Flow as JaxFlow
from fastmot_tpu.kalman import MeasType as JaxMeasType
from fastmot_tpu.track import Track as JaxTrack
from fastmot_tpu.tracker import MultiTracker as JaxMultiTracker
from fastmot_tpu_torch import Flow, KalmanFilter, MeasType, MultiTracker
from fastmot_tpu_torch.detector import make_detections
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.track import Track

from .test_torch_flow import jax_draws, textured_frames
from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

SIZE = (320, 240)
BOXES = np.array([[30, 40, 80, 150], [150, 50, 205, 170],
                  [240, 60, 290, 200]], float)


@pytest.fixture
def jax_ransac(monkeypatch):
    monkeypatch.setattr(tfk, 'ransac_draws',
                        lambda seed, f_cap, device: tuple(
                            u.to(device) for u in jax_draws(seed, f_cap)))


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_kalman_filter_matches_jax(rng):
    jkf = JaxKalmanFilter()
    tkf = KalmanFilter(device='cpu')
    for kf in (jkf, tkf):
        kf.reset_dt(1 / 25.0)
    close(tkf.trans_mat, jkf.trans_mat)
    close(tkf.acc_cov, jkf.acc_cov)
    det = np.array([100.0, 50.0, 160.0, 210.0])
    mean, cov = jkf.create(det)
    got = tkf.create(det)
    close(got[0], mean)
    close(got[1], cov)
    mean = mean + rng.normal(0, 2, 8).astype(np.float32)
    got, want = tkf.predict(mean, cov), jkf.predict(mean, cov)
    close(got[0], want[0])
    close(got[1], want[1])
    meas = det + rng.normal(0, 3, 4)
    for tm, jm in ((MeasType.FLOW, JaxMeasType.FLOW),
                   (MeasType.DETECTOR, JaxMeasType.DETECTOR)):
        for got, want in ((tkf.project(mean, cov, tm, 1.7),
                           jkf.project(mean, cov, jm, 1.7)),
                          (tkf.update(mean, cov, meas, tm, 2.0),
                           jkf.update(mean, cov, meas, jm, 2.0))):
            close(got[0], want[0])
            close(got[1], want[1])
    dets = det + rng.normal(0, 10, (6, 4))
    close(tkf.motion_distance(mean, cov, dets),
          jkf.motion_distance(mean, cov, dets))
    h_mat = np.array([[1.01, 0.02, -3.0], [-0.01, 0.99, 2.0],
                      [1e-5, -2e-5, 1.0]])
    got, want = tkf.warp(mean, cov, h_mat), jkf.warp(mean, cov, h_mat)
    close(got[0], want[0])
    close(got[1], want[1])


def tracks_of(cls):
    cls._count = 0
    return [cls(0, box, (np.zeros(8, np.float32), np.eye(8, dtype=np.float32)),
                1) for box in BOXES]


def test_flow_predict_matches_jax(jax_ransac):
    frames = textured_frames(np.random.default_rng(0),
                             [(0, 0), (4, 2), (8, 3)])
    jflow, tflow = JaxFlow(SIZE), Flow(SIZE, device='cpu')
    jtracks, ttracks = tracks_of(JaxTrack), tracks_of(Track)
    assert jflow.predict(frames[0], jtracks) == ({}, None)
    assert tflow.predict(frames[0], ttracks) == ({}, None)
    for frame in frames[1:]:
        want_boxes, want_h = jflow.predict(frame, jtracks)
        got_boxes, got_h = tflow.predict(torch.as_tensor(frame), ttracks)
        assert tflow.next_seed() == jflow.next_seed()
        assert got_boxes.keys() == want_boxes.keys() and len(got_boxes) == 3
        for tid, box in want_boxes.items():
            assert np.abs(got_boxes[tid] - box).max() <= 1.0, (tid, box)
        probe = np.array([[50, 50, 1], [250, 60, 1], [150, 200, 1]])
        for p in probe:
            g, w = got_h @ p, want_h @ p
            np.testing.assert_allclose(g[:2] / g[2], w[:2] / w[2], atol=0.05)
        for jt, tt in zip(jtracks, ttracks):
            assert abs(len(tt.keypoints) - len(jt.keypoints)) <= 2
            assert tt.inlier_ratio == pytest.approx(jt.inlier_ratio,
                                                    abs=0.1)
    # the scene moved by (-4, -2) between the first two frames
    assert np.abs(got_h[:2, 2] - [-4, -1]).max() < 1.0


def test_compute_flow_apply_kalman_matches_jax(jax_ransac):
    frames = textured_frames(np.random.default_rng(0),
                             [(2 * i, i) for i in range(5)])
    cfg = dict(max_age=6, confirm_hits=1)
    jtrk = JaxMultiTracker(SIZE, 'euclidean', **cfg)
    ttrk = MultiTracker(SIZE, 'euclidean', device='cpu', **cfg)
    runs = []
    for trk, make, as_frame in ((jtrk, jax_detections, np.asarray),
                                (ttrk, make_detections, torch.as_tensor)):
        trk.reset(1 / 30.0)
        trk.init(as_frame(frames[0]),
                 make(BOXES, np.ones(3, int), np.full(3, 0.9)))
        snaps = []
        for frame in frames[1:]:
            trk.compute_flow(as_frame(frame))
            trk.apply_kalman()
            snaps.append({tid: t.tlbr.copy() for tid, t in trk.tracks.items()})
        runs.append(snaps)
    want, got = runs
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and len(g) == 3
        for tid in w:
            np.testing.assert_allclose(g[tid], w[tid], atol=1e-2)
    assert ttrk.homography is not None and ttrk.klt_bboxes
    # the API-parity path leaves the device state to be rebuilt
    assert ttrk._mirrors_dirty
    groups, unconfirmed = ttrk._group_tracks_by_depth()
    assert sum(map(len, groups)) + len(unconfirmed) == 3
