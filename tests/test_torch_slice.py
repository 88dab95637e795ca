"""The port's whole tracking path against the JAX package: ``MOT`` with the
PUBLIC detector and OSNet-x0.25 (the configuration of
tests/test_step_batch.py) on the synthetic SYN-01 sequence of
tests/test_e2e.py, the same OSNet weights on both sides and the JAX
package's RANSAC draws fed to the port, then the port's own draws (JAX's
bit for bit) at skip 3 and 5: the same track IDs on every frame, boxes
within 2 px. Then the port's ``step_batch`` against its ``step``,
and its command line against the ground truth (MOTA and IDF1 >= 0.85)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fastmot_tpu import MOT as JaxMOT
from fastmot_tpu.eval import evaluate
from fastmot_tpu.models.registry import save_npz
from fastmot_tpu_torch import MOT
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.weights import load_npz

from .test_app_cli import LINE_RE, _write_gt, _write_jpegs
from .test_e2e import N_FRAMES, SEQ_SIZE, SIZE, make_sequence
from .test_torch_flow import jax_draws

ROOT = Path(__file__).parents[1]


def mot_cfg(seq, skip=3):
    return dict(detector_type='PUBLIC', detector_frame_skip=skip,
                class_ids=(1,),
                public_detector_cfg={'sequence_path': str(seq),
                                     'conf_thresh': 0.5,
                                     'max_area': 800000},
                feature_extractor_cfgs=({'model': 'OSNet025',
                                         'batch_size': 16},),
                tracker_cfg={'max_age': 6, 'confirm_hits': 1})


def run(mot, frames, batched=False):
    mot.reset(1 / 30.0)
    if batched:
        for lo in range(0, len(frames), 4):     # chunks across skip cycles
            mot.step_batch([f.copy() for f in frames[lo:lo + 4]])
    else:
        for frame in frames:
            mot.step(frame.copy())
    return {fid: sorted((tid, np.asarray(tlbr, float)) for tid, tlbr in rows)
            for fid, rows in mot.flush_tracks().items()}


def gt_frames(gt):
    """GT in processing-size tlwh, {frame: (ids, boxes)} (1-based)."""
    sx, sy = SIZE[0] / SEQ_SIZE[0], SIZE[1] / SEQ_SIZE[1]
    return {f + 1: (list(range(1, len(objs) + 1)),
                    [np.array([cx * sx, cy * sy, w * sx, h * sy])
                     for cx, cy, w, h in objs]) for f, objs in gt.items()}


def res_frames(snaps):
    return {f + 1: ([tid for tid, _ in rows],
                    [np.concatenate([t[:2], t[2:] - t[:2] + 1])
                     for _, t in rows]) for f, rows in snaps.items()}


@pytest.fixture(scope='module')
def sequence(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('slice')
    seq, frames, gt = make_sequence(tmp, np.random.default_rng(42))
    return tmp, seq, frames, gt


@pytest.fixture(scope='module')
def jax_run(sequence):
    """``jax_run(skip)``: the JAX package's rows at ``detector_frame_skip``
    ``skip`` and the path of its OSNet weights (made once per skip)."""
    tmp, seq, frames, _ = sequence
    done = {}

    def get(skip):
        if skip not in done:
            jmot = JaxMOT(SIZE, **mot_cfg(seq, skip))
            path = tmp / f'osnet025_skip{skip}.npz'
            save_npz(jmot.extractors[0].params, path)
            done[skip] = run(jmot, frames), path
        return done[skip]
    return get


def port_run(seq, frames, skip, weights):
    mot = MOT(SIZE, device='cpu', **mot_cfg(seq, skip))
    mot.extractors[0].module.load_state_dict(load_npz(weights))
    return run(mot, frames)


def assert_same_tracks(got, want):
    """The same track IDs on every frame, boxes within 2 px."""
    assert set(got) == set(want) == set(range(N_FRAMES))
    for fid in want:
        assert [t for t, _ in got[fid]] == [t for t, _ in want[fid]], fid
        for (_, a), (_, b) in zip(got[fid], want[fid]):
            assert np.abs(a - b).max() <= 2.0, (fid, a, b)


def test_slice_matches_jax(sequence, jax_run, monkeypatch):
    _, seq, frames, gt = sequence
    want, weights = jax_run(3)
    monkeypatch.setattr(tfk, 'ransac_draws',
                        lambda seed, f_cap, device: tuple(
                            u.to(device) for u in jax_draws(seed, f_cap)))
    got = port_run(seq, frames, 3, weights)
    assert_same_tracks(got, want)
    # at skip 3 the reference itself scores MOTA ~0.64 here (every track
    # is unconfirmed for its first skip cycle and one object is re-created
    # after frame 3): the port must score exactly what the JAX run scores;
    # the absolute 0.85 bound is held on the CLI run at skip 2 below, the
    # bound of tests/test_app_cli.py
    m = evaluate(gt_frames(gt), res_frames(got))
    m_ref = evaluate(gt_frames(gt), res_frames(want))
    assert (m.mota, m.idf1, m.idsw) == (m_ref.mota, m_ref.idf1,
                                        m_ref.idsw), (str(m), str(m_ref))
    assert m.mota > 0.5 and m.idf1 > 0.5, str(m)


@pytest.mark.parametrize('skip', [3, 5])
def test_slice_own_draws_match_jax(sequence, jax_run, skip):
    """Nothing injected: the port's own RANSAC draws (``ransac_draws``,
    JAX's threefry keys) give the JAX run's track IDs on every frame."""
    _, seq, frames, _ = sequence
    want, weights = jax_run(skip)
    assert_same_tracks(port_run(seq, frames, skip, weights), want)


def test_slice_step_batch_matches_step(sequence):
    """The port's own draws: step_batch (gap frames buffered across
    calls) gives exactly what per-frame step gives."""
    _, seq, frames, _ = sequence
    ref = run(MOT(SIZE, device='cpu', **mot_cfg(seq)), frames)
    got = run(MOT(SIZE, device='cpu', **mot_cfg(seq)), frames, batched=True)
    assert set(ref) == set(got)
    for fid in ref:
        assert [t for t, _ in got[fid]] == [t for t, _ in ref[fid]], fid
        for (_, a), (_, b) in zip(got[fid], ref[fid]):
            np.testing.assert_array_equal(a, b)
    assert sum(len(rows) for rows in ref.values()) > 30


def test_app_cli_txt(sequence, tmp_path):
    """``python -m fastmot_tpu_torch.app`` writes MOT-format rows that
    track the sequence."""
    _, seq, frames, gt = sequence
    if not (seq / 'img1').exists():
        _write_jpegs(seq, frames)
    gt_path = _write_gt(seq, gt)
    cfg = tmp_path / 'cfg.json'
    cfg.write_text(json.dumps({
        'resize_to': list(SIZE),
        'stream_cfg': {'resolution': list(SIZE), 'frame_rate': 30,
                       'buffer_size': 10},
        'mot_cfg': dict(mot_cfg(seq, skip=2),
                        feature_extractor_cfgs=[{'model': 'OSNet025'}])}))
    out = tmp_path / 'out.txt'
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, '-m', 'fastmot_tpu_torch.app', '-i',
         str(seq / 'img1' / '%06d.jpg'), '-c', str(cfg), '--mot', '--txt',
         str(out), '--device', 'cpu'], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = out.read_text().splitlines()
    assert len(lines) > 30
    for line in lines:
        assert LINE_RE.fullmatch(line), line
    from fastmot_tpu.eval import evaluate_files
    m = evaluate_files(gt_path, out)
    assert m.mota >= 0.85 and m.idf1 >= 0.85, str(m)


def _assoc_inputs(seed=5):
    """A mid-sequence tracker state: 12 tracks of mixed age and hits (two
    with their features in the history store), 14 detections, some on
    tracks, some new, two overlapping."""
    from fastmot_tpu import kalman as jkf
    from fastmot_tpu.tracker import FEAT_DIM, MAX_DETS, MAX_TRACKS
    rng = np.random.default_rng(seed)
    t, d, h = MAX_TRACKS, MAX_DETS, 64
    n_t, n_d = 12, 14
    boxes = np.zeros((t, 4), np.float32)
    xy = rng.uniform(0, 500, (n_t, 2))
    boxes[:n_t] = np.round(np.concatenate(
        [xy, xy + rng.uniform([30, 80], [60, 160], (n_t, 2))], 1))
    means, covs = (np.array(a) for a in jkf.batched_create(
        jkf.KalmanConfig(), boxes))
    feats = rng.normal(size=(t, FEAT_DIM)).astype(np.float32)
    valid = np.arange(t) < n_t
    state = [means, covs, boxes, valid,
             np.where(valid, rng.integers(0, 4, t), 0).astype(np.int32),
             np.where(valid, rng.integers(0, 3, t), 0).astype(np.int32),
             np.where(valid, 1, -2).astype(np.int32),
             np.zeros(t, np.int32), np.full(t, 8, np.int32),
             valid & (rng.uniform(size=t) < 0.2),
             np.ones(t, np.float32),
             np.zeros((t, 32, 2), np.float32), np.zeros((t, 32), bool),
             np.where(valid[:, None], feats, 0).astype(np.float32),
             np.where(valid, rng.integers(1, 4, t), 0).astype(np.float32)]
    hist = [np.zeros((h, FEAT_DIM), np.float32), np.zeros(h, np.float32),
            np.full(h, -2, np.int32), np.zeros(h, bool),
            np.zeros(h, np.int32), np.zeros(h, np.int32)]
    hist[0][:2] = rng.normal(size=(2, FEAT_DIM))
    hist[1][:2] = 3.0
    hist[2][:2] = 1
    hist[3][:2] = True
    hist[4][:2] = (3, 5)
    hist[5][:2] = 4
    d_tlbrs = np.zeros((d, 4), np.float32)
    d_tlbrs[:8] = boxes[:8] + rng.integers(-3, 4, (8, 4))
    d_tlbrs[8:n_d] = np.round(np.concatenate(
        [xy[:6] + 300, xy[:6] + 360 + rng.uniform(0, 60, (6, 2))], 1))
    d_tlbrs[13] = d_tlbrs[12] + 2                     # overlapping pair
    emb = np.zeros((d, FEAT_DIM), np.float32)
    emb[:8] = feats[:8] + rng.normal(0, 0.3, (8, FEAT_DIM))
    emb[8:n_d] = rng.normal(size=(6, FEAT_DIM))
    emb[10] = hist[0][0] + rng.normal(0, 0.1, FEAT_DIM)   # a reID match
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    dets = (d_tlbrs, np.where(np.arange(d) < n_d, 1, -1).astype(np.int32),
            np.where(np.arange(d) < n_d, 0.9, 0).astype(np.float32),
            np.arange(d) < n_d)
    return state, hist, dets, emb


def test_association_frame_matches_jax():
    """One association frame's costs, cascade stages, finals and commit
    (tracker.assoc_costs_core + scan_finals_commit_core) against the JAX
    package's _assoc_costs_kernel + _scan_finals_commit_kernel."""
    import torch
    from fastmot_tpu import kalman as jkf
    from fastmot_tpu import tracker as jtr
    from fastmot_tpu.ops import distance as jdist
    from fastmot_tpu_torch import kalman as tkf
    from fastmot_tpu_torch import tracker as ttr
    from fastmot_tpu_torch.ops import distance as tdist

    state, hist, dets, emb = _assoc_inputs()
    acc, _, trans = jkf.init_mats(jkf.KalmanConfig(), 1 / 30.0)
    rect = np.array([0, 0, 1279, 719], np.float32)
    args = (3, 0.2, 0.8, 0.6, 0.9, 0.7, 1)
    tail = (0.5, 0.6, 0.2, 1, 6, 50, 1e-2, 4.5)

    jcosts = jtr._assoc_costs_kernel(jkf.KalmanConfig(),
                                     jdist.Metric.EUCLIDEAN, *args,
                                     tuple(state), tuple(hist), *dets, emb)
    (cost, iou_cost, reid_cost, occl, h_ok, masks, base_a, base_u, u_det,
     c4r) = jcosts
    jstate, jhist, jinfo = jtr._scan_finals_commit_kernel(
        jkf.KalmanConfig(), 3, *tail, cost, iou_cost, masks, base_a,
        base_u, u_det, c4r, tuple(state), tuple(hist), *dets, emb,
        np.int32(9), rect, reid_cost, h_ok, occl)

    def t(a):
        return torch.from_numpy(np.array(a))
    tstate = tuple(t(a) for a in state)
    thist = tuple(t(a) for a in hist)
    tdets = tuple(t(a) for a in dets)
    tcosts = ttr.assoc_costs_core(tkf.KalmanConfig(), tdist.Metric.EUCLIDEAN,
                                  *args, tstate, thist, *tdets, t(emb))
    for got, want in zip(tcosts[:3], jcosts[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    (cost, iou_cost, reid_cost, occl, h_ok, masks, base_a, base_u, u_det,
     c4r) = tcosts
    new_state, new_hist, info = ttr.scan_finals_commit_core(
        tkf.KalmanConfig(), 3, *tail, cost, iou_cost, masks, base_a,
        base_u, u_det, c4r, tstate, thist, *tdets, t(emb), 9, t(rect),
        reid_cost, h_ok, occl)
    # the decisions (matches, merges, deletions, reinstates, creations,
    # history slots) and the rounded boxes are exact; the Kalman
    # means/covariances at the tail of the info vector agree to float32
    # rounding
    n_dec = 4 + 128 * 14 + 64 + 128 * 4
    np.testing.assert_array_equal(info.numpy()[:n_dec],
                                  np.asarray(jinfo)[:n_dec])
    np.testing.assert_allclose(info.numpy()[n_dec:],
                               np.asarray(jinfo)[n_dec:], rtol=1e-4,
                               atol=1e-2)
    for i in (3, 4, 5, 6, 7, 8):                 # valid ... end frames
        np.testing.assert_array_equal(new_state[i].numpy(),
                                      np.asarray(jstate[i]))
    for i in (2, 3, 4):                          # history labels/valid/lru
        np.testing.assert_array_equal(new_hist[i].numpy(),
                                      np.asarray(jhist[i]))
    a = jtr.MultiTracker.__new__(jtr.MultiTracker)
    a._hist_cap = 64
    decoded = a._unpack_assoc(np.asarray(jinfo))
    # the case exercises matches, creations, a reID reinstate, a history
    # save and an unconfirmed deletion
    assert (decoded['match_det'] >= 0).sum() >= 6
    assert (decoded['create_det'] >= 0).sum() >= 1
    assert (decoded['reinstate_hist'] >= 0).sum() == 1
    assert (decoded['hist_dst'] >= 0).sum() >= 1
    assert decoded['del_unconf'].sum() >= 1
