"""The port's flow ops (fastmot_tpu_torch/ops/flow_kernels.py) against the
JAX package: preprocessing (pyramid, uint8 rounding, Shi-Tomasi, grid
candidates with forced ties), point assembly, pyramidal LK, both RANSACs
with the same uniform draws, the port's own RANSAC draws (JAX's, bit for
bit), and one whole gap frame of the tracker."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from fastmot_tpu import kalman as jkf
from fastmot_tpu import tracker as jtr
from fastmot_tpu.ops import flow_kernels as jfk
from fastmot_tpu_torch import kalman as tkf
from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.ops import flow_kernels as tfk

SPEC_ARGS = dict(size=(320, 240), opt_scale=(0.5, 0.5), bg_scale=(0.1, 0.1))
JSPEC = jfk.FlowSpec(**SPEC_ARGS)
TSPEC = tfk.FlowSpec(**SPEC_ARGS)


def T(a):
    return torch.from_numpy(np.array(a))


def textured_frames(rng, shifts, h=240, w=320, pad=32):
    base = ndi.gaussian_filter(
        rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad)).astype(np.float32), 2)
    return [np.stack([base[pad + dy:pad + dy + h, pad + dx:pad + dx + w]] * 3,
                     -1).astype(np.uint8) for dx, dy in shifts]


def jax_draws(seed, f_cap):
    """The JAX package's RANSAC uniforms for a flow seed
    (flow_kernels.flow_post_core's keys)."""
    key = jax.random.PRNGKey(jnp.uint32(seed))
    u_h = jax.random.uniform(jax.random.fold_in(key, 0), (jfk.HYP_H, 4))
    keys = jax.random.split(jax.random.fold_in(key, 1), f_cap)
    u_a = jax.vmap(lambda k: jax.random.uniform(k, (jfk.HYP_A, 2)))(keys)
    return T(u_h), T(u_a)


@pytest.fixture(scope='module')
def states():
    """Two consecutive frames preprocessed by both packages."""
    frames = textured_frames(np.random.default_rng(0), [(0, 0), (5, 3)])
    jst = [jfk.preprocess(JSPEC, f) for f in frames]
    tst = [tfk.preprocess(TSPEC, torch.from_numpy(f)) for f in frames]
    return frames, jst, tst


def test_resize_matches_jax_lerp_matrices(rng):
    """``resize_bilinear`` (F.interpolate's bilinear, align_corners=False,
    no antialias) has the hat weights of the JAX package's interpolation
    matrices."""
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    for out_hw in ((120, 160), (24, 32), (97, 131)):
        got = tfk.resize_bilinear(T(img), out_hw).numpy()
        want = np.asarray(jfk._resize_bilinear(jnp.asarray(img), out_hw))
        np.testing.assert_allclose(got, want, atol=2e-3)


def test_preprocess_matches_jax(states):
    _, jst, tst = states
    for (jpyr, jtabs, jcp, jcs, jbp, jbs), (pyr, pyr_u8, cp, cs, bp, bs) in \
            zip(jst, tst):
        off = 0
        wide = JSPEC.win + 3
        center = (JSPEC.win - 1) // 2 + 1
        for jl, tl, tu in zip(jpyr, pyr, pyr_u8):
            jl = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), jl, atol=2e-3)
            # LK samples: the level rounded to uint8, as in the JAX
            # package's window tables (centre tap of each pixel's row)
            h, w = jl.shape
            tab = np.asarray(jtabs[off:off + h * w]).reshape(h, w, wide, wide)
            off += h * w
            ju8 = tab[:, :, center, center].astype(np.float32)
            clear = np.abs(jl - np.floor(jl) - 0.5) > 1e-3
            np.testing.assert_array_equal(tu.numpy()[clear], ju8[clear])
            assert (tu.numpy() != ju8).mean() < 1e-3
        np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp))
        np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))
        np.testing.assert_allclose(bs.numpy(), np.asarray(jbs), rtol=1e-4,
                                   atol=1e-2)


def test_grid_candidates_forced_ties(rng):
    """The first row-major maximum of each cell wins, as in the JAX
    package's reduce_window formulation."""
    resp = np.round(rng.uniform(0, 3, (48, 64))).astype(np.float32)
    resp[8:16, 16:24] = 7.0                  # a whole cell tied
    resp[0:8, 0:8] = 0.0
    resp[3, 6] = resp[5, 1] = 9.0            # tie across rows
    got_pts, got_score = tfk.grid_candidates(T(resp), 8)
    want_pts, want_score = jfk._grid_candidates(jnp.asarray(resp), 8)
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    np.testing.assert_array_equal(got_score.numpy(), np.asarray(want_score))
    assert tuple(got_pts[0].tolist()) == (6.0, 3.0)
    assert tuple(got_pts[8 + 2].tolist()) == (16.0, 8.0)


def test_shi_tomasi_matches_jax(rng):
    img = ndi.gaussian_filter(rng.uniform(0, 255, (60, 80)), 1.5) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tfk.shi_tomasi_response(T(img)).numpy(),
        np.asarray(jfk._shi_tomasi_response(jnp.asarray(img))),
        rtol=1e-4, atol=1e-2)


def _tracks(n, f_cap):
    tlbrs = np.zeros((f_cap, 4), np.float32)
    tlbrs[:n] = [[30 + 60 * i, 40 + 10 * i, 80 + 60 * i, 150 + 10 * i]
                 for i in range(n)]
    valid = np.arange(f_cap) < n
    kps = np.zeros((f_cap, tfk.KP_PER_TRACK, 2), np.float32)
    kpv = np.zeros((f_cap, tfk.KP_PER_TRACK), bool)
    kps[0, :6] = [[40 + 3 * k, 60 + 5 * k] for k in range(6)]
    kpv[0, :6] = True                        # a track with few keypoints
    return tlbrs, valid, kps, kpv


def test_flow_points_matches_jax(states):
    _, jst, tst = states
    tlbrs, valid, kps, kpv = _tracks(4, 32)
    got = tfk.flow_points_core(TSPEC, tst[0], T(tlbrs), T(valid), T(kps),
                               T(kpv))
    want = jfk.flow_points_core(JSPEC, jst[0], tlbrs, valid, kps, kpv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() > 50


def test_lk_matches_jax(states):
    _, jst, tst = states
    rng = np.random.default_rng(1)
    pts = rng.uniform(10, 310, (300, 2)).astype(np.float32)
    pts[:, 1] *= 0.75
    valid = rng.uniform(size=300) < 0.9
    got_pts, got_ok = tfk.lk_core(TSPEC, tst[0][1], tst[1][1], T(pts),
                                  T(valid))
    want_pts, want_ok = jax.jit(jfk.lk_core, static_argnames='spec')(
        JSPEC, jst[0][0], jst[0][1], jst[1][0], jst[1][1], pts, valid)
    want_pts, want_ok = np.asarray(want_pts), np.asarray(want_ok)
    got_pts, got_ok = got_pts.numpy(), got_ok.numpy()
    assert (got_ok == want_ok).mean() > 0.99
    both = got_ok & want_ok
    assert both.sum() > 200
    # a pyramid value a float32 ulp from .5 can round to another uint8,
    # which moves a point by a few hundredths of a pixel
    diff = np.abs(got_pts[both] - want_pts[both]).max(1)
    assert (diff < 1e-3).mean() > 0.9, np.sort(diff)[-20:]
    assert diff.max() < 0.1, diff.max()
    # the scene moved by (-5, -3)
    np.testing.assert_allclose(np.median(got_pts[both] - pts[both], 0),
                               [-5, -3], atol=0.3)


def test_ransac_homography_same_draws(rng):
    n = 200
    pts = rng.uniform(20, 300, (n, 2)).astype(np.float32)
    h_true = np.array([[1.02, 0.01, -4.0], [-0.005, 0.99, 2.5],
                       [1e-5, -5e-6, 1.0]], np.float32)
    proj = np.concatenate([pts, np.ones((n, 1), np.float32)], 1) @ h_true.T
    cur = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
    cur += rng.normal(0, 0.3, cur.shape).astype(np.float32)
    outliers = rng.uniform(size=n) < 0.25
    cur[outliers] += rng.uniform(-80, 80, (outliers.sum(), 2)) \
        .astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (jfk.HYP_H, 4))
    ok, h_mat, inl = tfk.ransac_homography(T(pts), T(cur), T(valid), T(u), 4)
    jok, jh, jinl = jax.jit(jfk.ransac_homography, static_argnums=4)(
        pts, cur, valid, key, 4)
    assert bool(ok) and bool(jok)
    probe = np.array([[50, 50, 1], [250, 60, 1], [150, 200, 1]], np.float32)
    for p in probe:
        g, w = h_mat.numpy() @ p, np.asarray(jh) @ p
        np.testing.assert_allclose(g[:2] / g[2], w[:2] / w[2], atol=0.05)
    assert (inl.numpy() == np.asarray(jinl)).mean() > 0.99


def test_ransac_similarity_same_draws(rng):
    n_trk, k = 5, tfk.KP_PER_TRACK
    prev = rng.uniform(0, 100, (n_trk, k, 2)).astype(np.float32)
    th, s = 0.05, 1.04
    a, b = s * np.cos(th), s * np.sin(th)
    cur = np.stack([a * prev[..., 0] - b * prev[..., 1] + 7.0,
                    b * prev[..., 0] + a * prev[..., 1] - 3.0], -1)
    cur = (cur + rng.normal(0, 0.2, cur.shape)).astype(np.float32)
    cur[:, :6] += 40.0                                  # outliers
    valid = rng.uniform(size=(n_trk, k)) < 0.8
    valid[4, 2:] = False                                # too few points
    keys = jax.random.split(jax.random.PRNGKey(3), n_trk)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (jfk.HYP_A, 2)))(keys)
    got = tfk.ransac_similarity(T(prev), T(cur), T(valid), T(u), 4)
    want = jax.jit(jax.vmap(
        lambda p, c, v, kk: jfk.ransac_similarity(p, c, v, kk, 4)))(
        prev, cur, valid, keys)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    ok = got[0].numpy()
    np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok],
                               atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize('f_cap', [1, 16, 128])
@pytest.mark.parametrize('seed', [0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1])
def test_ransac_draws_match_jax_bit_for_bit(seed, f_cap):
    """The port's own draws are the JAX package's: every float32 equal to
    the bit."""
    got, want = tfk.ransac_draws(seed, f_cap, 'cpu'), jax_draws(seed, f_cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_ransac_draws_batch_is_per_seed():
    """One call for every stream's seed gives each seed's own draws, bit
    for bit (the StreamTracker and dryrun call)."""
    seeds = [0, 3, 2 ** 32 - 1, 41]
    u_h, u_a = tfk.ransac_draws_batch(seeds, 48, 'cpu')
    assert u_h.shape == (4, tfk.HYP_H, 4) and \
        u_a.shape == (4, 48, tfk.HYP_A, 2)
    for s, seed in enumerate(seeds):
        one_h, one_a = tfk.ransac_draws(seed, 48, 'cpu')
        assert torch.equal(u_h[s].view(torch.int32), one_h.view(torch.int32))
        assert torch.equal(u_a[s].view(torch.int32), one_a.view(torch.int32))


def test_gap_frame_matches_jax(states):
    """One whole gap frame: points, LK, RANSAC with the port's draws of
    the same seed (JAX's, bit for bit), the Kalman warp/predict/update and
    the commit (the tracker's per-frame functions against their JAX
    twins)."""
    frames, jst, tst = states
    cfg = jkf.KalmanConfig()
    t_cap, f_cap = jtr.MAX_TRACKS, 32
    tlbrs, _, kps, kpv = _tracks(4, t_cap)
    means, covs = (np.asarray(a) for a in jkf.batched_create(cfg, tlbrs))
    state = [means, covs, tlbrs, np.arange(t_cap) < 4,
             np.zeros(t_cap, np.int32), np.ones(t_cap, np.int32),
             np.ones(t_cap, np.int32), np.zeros(t_cap, np.int32),
             np.zeros(t_cap, np.int32), np.zeros(t_cap, bool),
             np.ones(t_cap, np.float32), kps, kpv,
             np.zeros((t_cap, jtr.FEAT_DIM), np.float32),
             np.zeros(t_cap, np.float32)]
    acc, _, trans = jkf.init_mats(cfg, 1 / 30.0)
    rect = np.array([0, 0, 319, 239], np.float32)

    (all_prev, all_valid, inside, forder, f_tlbrs,
     f_valid) = jtr._gap_points_kernel(JSPEC, tuple(state), jst[0],
                                       f_cap=f_cap)
    jstate, jinfo, _ = jtr._lk_commit_kernel(
        cfg, JSPEC, 2.0, 1, jst[0][0], jst[0][1], jst[1][0], jst[1][1],
        all_prev, all_valid, tuple(state), inside, f_tlbrs, f_valid, forder,
        jnp.uint32(7), trans, acc, rect)

    tstate_in = tuple(T(a) for a in state)
    pts = ttr.gap_points_core(TSPEC, tstate_in, tst[0], f_cap)
    tstate, tinfo = ttr.lk_commit_core(
        tkf.KalmanConfig(), TSPEC, 2.0, 1, tst[0][1], tst[1][1], pts[0],
        pts[1], tstate_in, pts[2], pts[4], pts[5], pts[3], 7, T(trans),
        T(acc), T(rect))
    np.testing.assert_array_equal(pts[3].numpy(), np.asarray(forder))
    np.testing.assert_array_equal(tinfo.numpy()[0], np.asarray(jinfo)[0])
    for i in (2, 3, 9, 12):             # boxes, valid, lost_pending, kpv
        np.testing.assert_allclose(tstate[i].numpy(), np.asarray(jstate[i]),
                                   atol=1.0)
    np.testing.assert_allclose(tstate[0].numpy(), np.asarray(jstate[0]),
                               rtol=1e-3, atol=0.05)
