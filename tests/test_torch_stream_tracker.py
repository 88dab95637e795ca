"""The port's ``parallel.StreamTracker`` against the JAX package's, in the
scenario of tests/test_stream_tracker.py (2 streams at 160x120, 7 frames,
an association every 3rd frame, synthetic detections and embeddings), with
the JAX package's RANSAC draws fed to the port; against two independent
port ``MultiTracker``s fed the same inputs; and with a sync only at the
end, where the replay order (stream-major) sets the IDs of the tracks
created since the last sync."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu.parallel.stream_tracker import \
    StreamTracker as JaxStreamTracker
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.parallel import StreamTracker
from fastmot_tpu_torch.track import Track
from fastmot_tpu_torch.tracker import MultiTracker

from .test_stream_tracker import (SIZE, dets_for, det_device, embs_for,
                                  make_frames, snapshot)
from .test_torch_flow import jax_draws
from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

N_STREAMS, N_FRAMES, SKIP = 2, 7, 3
# 160x120 frames only fit a 3-level pyramid
CFG = dict(max_age=3, confirm_hits=1,
           flow_cfg={'opt_flow_params': {'maxLevel': 2}})


def frames_of():
    return [make_frames(np.random.default_rng(s), N_FRAMES, shift_x=1 + s)
            for s in range(N_STREAMS)]


def dets_with_newcomers(f, offset):
    """``dets_for`` plus one new object at each association frame, so that
    every stream creates a track while its infos are pending."""
    det = dets_for(f, offset)
    if f and f % SKIP == 0:
        from fastmot_tpu.detector import make_detections
        x = 40.0 + 15 * (f // SKIP) + offset
        extra = np.array([[x, 10.0, x + 25, 55.0]])
        det = make_detections(np.concatenate([det.tlbr, extra]),
                              np.ones(len(det) + 1, int),
                              np.full(len(det) + 1, 0.9))
    return det


def run_stream_tracker(st, frames, dets_fn=dets_for, sync_every=True,
                       as_array=jnp.asarray):
    st.reset(1 / 30.0)
    st.init(as_array(np.stack([frames[s][0] for s in range(N_STREAMS)])),
            [dets_fn(0, 10 * s) for s in range(N_STREAMS)])
    for f in range(1, N_FRAMES):
        st.track(as_array(np.stack([frames[s][f]
                                    for s in range(N_STREAMS)])))
        if f % SKIP == 0:
            dets = [det_device(dets_fn(f, 10 * s)) for s in range(N_STREAMS)]
            det_b = tuple(as_array(np.stack([d[i] for d in dets]))
                          for i in range(4))
            st.update_device(f, det_b, as_array(np.stack(
                [embs_for(f, s) for s in range(N_STREAMS)])))
        if sync_every:
            st.sync()
    st.sync()
    return ([snapshot(t) for t in st.trackers],
            [sorted(t.hist_tracks) for t in st.trackers])


def tensor(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture
def jax_ransac(monkeypatch):
    monkeypatch.setattr(tfk, 'ransac_draws_batch',
                        lambda seeds, f_cap, device: tuple(
                            torch.stack(u).to(device) for u in
                            zip(*(jax_draws(s, f_cap) for s in seeds))))


@pytest.fixture(scope='module')
def jax_runs():
    """The JAX StreamTracker, synced every frame and only at the end."""
    frames = frames_of()
    st = JaxStreamTracker(SIZE, 'euclidean', N_STREAMS, **CFG)
    return (run_stream_tracker(st, frames),
            run_stream_tracker(st, frames, dets_with_newcomers,
                               sync_every=False))


def assert_same(got, want, atol):
    (g_snaps, g_hist), (w_snaps, w_hist) = got, want
    for s in range(N_STREAMS):
        assert g_snaps[s].keys() == w_snaps[s].keys(), (s, g_snaps[s],
                                                        w_snaps[s])
        for tid, (g_tlbr, *g_rest) in g_snaps[s].items():
            w_tlbr, *w_rest = w_snaps[s][tid]
            np.testing.assert_allclose(g_tlbr, w_tlbr, atol=atol)
            assert g_rest == w_rest, (s, tid, g_rest, w_rest)  # age, hits,
        assert g_hist[s] == w_hist[s]                          # label
    assert sum(len(snap) for snap in g_snaps) >= 4


def test_stream_tracker_matches_jax(jax_runs, jax_ransac):
    st = StreamTracker(SIZE, 'euclidean', N_STREAMS, device='cpu', **CFG)
    got = run_stream_tracker(st, frames_of(), as_array=tensor)
    assert_same(got, jax_runs[0], atol=1e-2)


def test_stream_tracker_sync_at_end_matches_jax(jax_runs, jax_ransac):
    """Tracks created on both streams while their infos are pending take
    their IDs in the JAX package's stream-major replay order."""
    st = StreamTracker(SIZE, 'euclidean', N_STREAMS, device='cpu', **CFG)
    got = run_stream_tracker(st, frames_of(), dets_with_newcomers,
                             sync_every=False, as_array=tensor)
    assert_same(got, jax_runs[1], atol=1e-2)
    # tracks 1-4 come from frame 0; stream 0 replays both of its
    # association frames first and creates 5 and 6 (5, unconfirmed and
    # unmatched at frame 6, is deleted), stream 1 then creates 7 and 8;
    # a replay frame by frame would give stream 0 tracks 5 and 7
    assert [max(snap) for snap in got[0]] == [6, 8], got[0]


def test_stream_tracker_matches_independent_trackers():
    """With the port's own draws: the batched state gives what two
    MultiTrackers give, synced every frame."""
    frames = frames_of()
    refs = [MultiTracker(SIZE, 'euclidean', device='cpu', **CFG)
            for _ in range(N_STREAMS)]
    for trk in refs:
        trk.reset(1 / 30.0)
    Track._count = 0
    for s, trk in enumerate(refs):
        trk.init(tensor(frames[s][0]), dets_for(0, 10 * s))
    for f in range(1, N_FRAMES):
        for s, trk in enumerate(refs):
            trk.track(tensor(frames[s][f]))
        if f % SKIP == 0:
            for s, trk in enumerate(refs):
                trk.update_device(f, tuple(tensor(a) for a in det_device(
                    dets_for(f, 10 * s))), tensor(embs_for(f, s)))
        for trk in refs:
            trk.sync()
    want = ([snapshot(t) for t in refs], [sorted(t.hist_tracks)
                                          for t in refs])
    st = StreamTracker(SIZE, 'euclidean', N_STREAMS, device='cpu', **CFG)
    got = run_stream_tracker(st, frames, as_array=tensor)
    assert_same(got, want, atol=1e-5)
