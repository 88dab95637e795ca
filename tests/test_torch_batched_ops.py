"""The port's solvers with a leading stream axis (one host loop for every
stream): ``auction_lap``, ``greedy_match_arrays``, ``greedy_suppress``
and ``lk_core`` on a batch equal the per-stream calls exactly, on inputs
whose streams converge after different numbers of rounds, and equal
``jax.vmap`` of the JAX functions (exact for indices and masks, LK points
within tests/test_torch_flow.py's tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu.ops import assignment as jasg
from fastmot_tpu.ops import flow_kernels as jfk
from fastmot_tpu.ops import geometry as jgeom
from fastmot_tpu_torch.ops import assignment as tasg
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.ops import geometry as tgeom

from .test_torch_flow import JSPEC, TSPEC, textured_frames
from .test_torch_ops import random_boxes
from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)


def T(a):
    return torch.from_numpy(np.array(a))


def auction_batch(rng, r=24, c=20):
    """A contested dense problem, a near-diagonal gated one (each row has
    one finite entry, as Mahalanobis gating leaves), a sparse one with
    masked rows and columns, and one with nothing allowed."""
    cost = rng.uniform(0, 1, (4, r, c)).astype(np.float32)
    cost[1] = jasg.INF_COST
    for i in range(min(r, c)):
        cost[1, i, (i * 7) % c] = rng.uniform(0, 1)
    cost[2] = np.where(rng.uniform(size=(r, c)) < 0.2, cost[2],
                       jasg.INF_COST)
    cost[3] = jasg.INF_COST
    row_valid = np.ones((4, r), bool)
    col_valid = np.ones((4, c), bool)
    row_valid[2, ::3] = False
    col_valid[2, 1::4] = False
    return cost, row_valid, col_valid


@pytest.mark.parametrize('max_iters', [8, 10000])
def test_batched_auction_equals_per_stream_and_jax_vmap(rng, max_iters):
    cost, rv, cv = auction_batch(rng)
    got = tasg.auction_lap(T(cost), T(rv), T(cv), eps_final=1e-2,
                           max_iters=max_iters)
    for s in range(len(cost)):
        one = tasg.auction_lap(T(cost[s]), T(rv[s]), T(cv[s]),
                               eps_final=1e-2, max_iters=max_iters)
        for g, o in zip(got, one):
            assert torch.equal(g[s], o), s
    want = jax.vmap(lambda c, r, v: jasg.auction_lap(
        c, r, v, eps_final=1e-2, max_iters=max_iters))(cost, rv, cv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c4r = got[1].numpy()
    assert (c4r[0] >= 0).sum() == 20 and (c4r[3] < 0).all()
    if max_iters == 8:
        # the cap cuts the contested stream short and leaves the
        # near-diagonal and the empty ones as they are: the streams need
        # different numbers of rounds
        full = tasg.auction_lap(T(cost), T(rv), T(cv), eps_final=1e-2)[1]
        assert not torch.equal(got[1][0], full[0])
        assert torch.equal(got[1][[1, 3]], full[[1, 3]])


def test_batched_greedy_match_equals_per_stream_and_jax_vmap(rng):
    cost = rng.uniform(0, 1, (3, 30, 25)).astype(np.float32)
    cost[1, :, :] = np.round(cost[1] * 4) / 4           # ties
    cost[2] += 0.5                                      # few under the gate
    rv = rng.uniform(size=(3, 30)) < 0.8
    cv = rng.uniform(size=(3, 25)) < 0.8
    got = tasg.greedy_match_arrays(T(cost), T(rv), T(cv), 0.6)
    for s in range(3):
        one = tasg.greedy_match_arrays(T(cost[s]), T(rv[s]), T(cv[s]), 0.6)
        for g, o in zip(got, one):
            assert torch.equal(g[s], o), s
    want = jax.vmap(lambda c, r, v: jasg.greedy_match_arrays(
        c, r, v, 0.6))(cost, rv, cv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_matched = (got[1].numpy() >= 0).sum(1)
    assert len(set(n_matched)) == 3, n_matched


def test_batched_greedy_suppress_equals_per_stream_and_jax_vmap(rng):
    boxes = np.stack([random_boxes(rng, 64, size=s) for s in (60, 120, 400)])
    scores = np.round(rng.uniform(0, 1, (3, 64)), 1).astype(np.float32)
    valid = rng.uniform(size=(3, 64)) < 0.9
    overlap = np.asarray(jax.vmap(lambda b: jgeom._diou_matrix(b, 0.6))(
        boxes))
    got = tgeom.greedy_suppress(T(overlap), T(scores), T(valid), 0.5)
    for s in range(3):
        one = tgeom.greedy_suppress(T(overlap[s]), T(scores[s]),
                                    T(valid[s]), 0.5)
        assert torch.equal(got[s], one), s
    want = jax.vmap(lambda o, sc, v: jgeom._greedy_suppress(o, sc, v, 0.5))(
        overlap, scores, valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # crowded, medium and sparse scenes keep different shares
    assert len(set(got.numpy().sum(1))) == 3


def test_batched_lk_equals_per_stream_and_jax_vmap():
    """A still stream (its points stop after one step per level) beside a
    moving one."""
    rng = np.random.default_rng(1)
    frames = [textured_frames(np.random.default_rng(s), shifts)
              for s, shifts in ((3, [(0, 0), (0, 0)]), (0, [(0, 0), (5, 3)]))]
    pts = rng.uniform(10, 310, (2, 300, 2)).astype(np.float32)
    pts[..., 1] *= 0.75
    valid = rng.uniform(size=(2, 300)) < 0.9
    tst = [tfk.preprocess(TSPEC, T(np.stack([f[i] for f in frames])))
           for i in (0, 1)]
    got_pts, got_ok = tfk.lk_core(TSPEC, tst[0][1], tst[1][1], T(pts),
                                  T(valid))
    for s in range(2):
        one = [tfk.preprocess(TSPEC, T(frames[s][i])) for i in (0, 1)]
        o_pts, o_ok = tfk.lk_core(TSPEC, one[0][1], one[1][1], T(pts[s]),
                                  T(valid[s]))
        assert torch.equal(got_pts[s], o_pts) and torch.equal(got_ok[s],
                                                              o_ok), s
    jst = [jax.tree.map(lambda *a: jnp.stack(a),
                        *[jfk.preprocess(JSPEC, f[i]) for f in frames])
           for i in (0, 1)]
    want_pts, want_ok = jax.jit(jax.vmap(
        lambda *a: jfk.lk_core(JSPEC, *a)))(
        jst[0][0], jst[0][1], jst[1][0], jst[1][1], pts, valid)
    want_pts, want_ok = np.asarray(want_pts), np.asarray(want_ok)
    got_pts, got_ok = got_pts.numpy(), got_ok.numpy()
    assert (got_ok == want_ok).mean() > 0.99
    both = got_ok & want_ok
    assert both.sum() > 400
    diff = np.abs(got_pts[both] - want_pts[both]).max(1)
    assert (diff < 1e-3).mean() > 0.9, np.sort(diff)[-20:]
    assert diff.max() < 0.1, diff.max()
    for s, shift in enumerate(([0, 0], [-5, -3])):
        np.testing.assert_allclose(
            np.median(got_pts[s][both[s]] - pts[s][both[s]], 0), shift,
            atol=0.3)
