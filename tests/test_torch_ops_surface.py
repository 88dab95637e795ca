"""The rest of the port's ops, Kalman and int8 surface against the JAX
package, on the same seeded numpy inputs:

- ``ops.geometry``'s ``to_tlwh``, ``intersection``, ``iom``, ``nms_mask``,
  ``diou_nms_mask`` and ``ops.distance``'s ``INF_DIST``, ``giou_dist``,
  ``diou_dist``: the cases of tests/test_geometry.py and
  tests/test_distance.py, and random boxes through both packages, to 1e-6
  relative in float32 and equal masks; ``ops`` exports the JAX names;
- ``kalman.warp_mean_fn`` and the five ``batched_*`` aliases against
  ``fastmot_tpu.kalman``'s, to 1e-5 relative (float32, sums in another
  order);
- ``models.quantize``'s functional API against JAX ``quantize.py``: int8
  leaves and scales equal to the bit, ``make_quantized_apply`` within the
  weight-only bounds of tests/test_torch_quantize.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu import kalman as jkf
from fastmot_tpu import ops as jops
from fastmot_tpu.models import osnet as josnet
from fastmot_tpu.models import quantize as jq
from fastmot_tpu_torch import kalman as tkf
from fastmot_tpu_torch import ops as tops
from fastmot_tpu_torch.models import osnet as tosnet
from fastmot_tpu_torch.models import quantize as tq

from .test_geometry import np_area, np_greedy_nms, random_boxes
from .test_torch_quantize import (CROPS, MAX_REL, MEAN_REL, flax_leaf,
                                  port_model, rel, to_flax)

REL = 1e-6
KF_REL = 1e-5


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, rtol=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_ops_exports_the_jax_names():
    import fastmot_tpu.ops as jpkg
    names = [n for n in dir(jpkg) if not n.startswith('_')
             and n not in ('annotations',)
             and not isinstance(getattr(jpkg, n), type(jpkg))]
    missing = [n for n in names if not hasattr(tops, n)]
    assert not missing and len(names) >= 30
    assert tops.INF_DIST == jops.INF_DIST


def test_tlwh_roundtrip(rng):
    b = random_boxes(rng, 16)
    tlwh = tops.to_tlwh(t(b))
    close(tlwh, jops.to_tlwh(b))
    np.testing.assert_array_equal(tops.to_tlbr(tlwh).numpy(), b)


def test_intersection_matches_jax(rng):
    a, b = random_boxes(rng, 64), random_boxes(rng, 64)
    box, valid = tops.intersection(t(a), t(b))
    jbox, jvalid = jops.intersection(a, b)
    close(box, jbox)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.any() and not valid.all()


def test_iom(rng):
    a, b = random_boxes(rng, 64), random_boxes(rng, 64)
    tl = np.maximum(a[:, :2], b[:, :2])
    br = np.minimum(a[:, 2:], b[:, 2:])
    wh = br - tl + 1
    inter = np.where((wh > 0).all(-1), wh[:, 0] * wh[:, 1], 0.0)
    got = tops.iom(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, inter / np.minimum(np_area(a),
                                                       np_area(b)),
                               rtol=1e-5)
    close(got, jops.iom(a, b))


@pytest.mark.parametrize('diou', [False, True])
def test_nms(rng, diou):
    """tests/test_geometry.py::test_nms on the port, and the JAX mask."""
    n = 60
    b = random_boxes(rng, n)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[50:] = False
    fn, jfn = (tops.diou_nms_mask, jops.diou_nms_mask) if diou else \
        (tops.nms_mask, jops.nms_mask)
    got = fn(t(b), t(scores), t(valid), 0.5).numpy()
    np.testing.assert_array_equal(got[:50], np_greedy_nms(
        b[:50], scores[:50], 0.5, diou=diou))
    assert not got[50:].any()
    np.testing.assert_array_equal(got, np.asarray(jfn(b, scores, valid,
                                                      0.5)))


def test_nms_dense_matches_jax(rng):
    """The chain-heavy layouts of test_nms_wave_equals_sequential_dense,
    with tied scores, both masks."""
    for trial in range(3):
        b = random_boxes(rng, 200, img=(400, 300))
        scores = np.round(rng.uniform(0.1, 1.0, 200), 2).astype(np.float32)
        valid = rng.uniform(size=200) < 0.9
        for fn, jfn in ((tops.nms_mask, jops.nms_mask),
                        (tops.diou_nms_mask, jops.diou_nms_mask)):
            np.testing.assert_array_equal(
                fn(t(b), t(scores), t(valid), 0.3).numpy(),
                np.asarray(jfn(b, scores, valid, 0.3)), err_msg=str(trial))


@pytest.mark.parametrize('name', ['giou_dist', 'diou_dist'])
def test_box_distances_match_jax(rng, name):
    a, b = random_boxes(rng, 40), random_boxes(rng, 25)
    got = getattr(tops, name)(t(a), t(b)).numpy()
    close(got, getattr(jops, name)(a, b))
    assert got.shape == (40, 25)


def test_diou_dist_range(rng):
    """tests/test_distance.py::test_diou_dist_range on the port."""
    a = random_boxes(rng, 12)
    got = tops.diou_dist(t(a), t(a)).numpy()
    np.testing.assert_allclose(np.diag(got), 0.0, atol=1e-5)
    assert (got >= -1e-5).all() and (got <= 1.0 + 1e-5).all()


# --- Kalman aliases --------------------------------------------------------

def _states(rng, n=12):
    tl = rng.uniform(50, 600, (n, 2))
    wh = rng.uniform(20, 120, (n, 2))
    means = np.concatenate([tl, tl + wh, rng.normal(0, 3, (n, 4))], 1)
    a = rng.normal(size=(n, 8, 8))
    covs = a @ a.transpose(0, 2, 1) + 8 * np.eye(8)
    return means.astype(np.float32), covs.astype(np.float32)


H_MAT = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0],
                  [2e-5, -1e-5, 1.0]], np.float32)


def test_kalman_aliases_match_jax(rng):
    cfg_t, cfg_j = tkf.KalmanConfig(), jkf.KalmanConfig()
    means, covs = _states(rng)
    dets = means[:, :4] + rng.normal(0, 2, (12, 4)).astype(np.float32)
    for got, want in zip(tkf.batched_create(cfg_t, t(dets)),
                         jkf.batched_create(cfg_j, dets)):
        close(got, want, KF_REL)
    acc, _, trans = tkf.init_mats(cfg_t, 1 / 30.0)
    jacc, _, jtrans = jkf.init_mats(cfg_j, 1 / 30.0)
    for got, want in zip(
            tkf.batched_predict(cfg_t, t(means), t(covs), t(trans), t(acc)),
            jkf.batched_predict(cfg_j, means, covs, jtrans, jacc)):
        close(got, want, KF_REL)
    flow = rng.uniform(size=12) < 0.5
    mult = rng.uniform(1, 3, 12).astype(np.float32)
    for got, want in zip(
            tkf.batched_update(cfg_t, t(means), t(covs), t(dets), t(flow),
                               t(mult)),
            jkf.batched_update(cfg_j, means, covs, dets, jnp.asarray(flow),
                               mult)):
        close(got, want, KF_REL)
    close(tkf.batched_maha_distance(cfg_t, t(means), t(covs), t(dets)),
          jkf.batched_maha_distance(cfg_j, means, covs, dets), KF_REL)


def test_batched_warp_matches_jax_and_the_closed_form(rng):
    means, covs = _states(rng)
    got = tkf.batched_warp(t(means), t(covs), t(H_MAT))
    for g, w in zip(got, jkf.batched_warp(means, covs, H_MAT)):
        close(g, w, KF_REL)
    for g, w in zip(got, tkf.warp(t(means), t(covs), t(H_MAT))):
        close(g, w, KF_REL)
    close(tkf.warp_mean_fn(t(means[0]), t(H_MAT)),
          jkf.warp_mean_fn(means[0], H_MAT), KF_REL)


# --- int8 functional API ---------------------------------------------------

def test_quantize_params_int8_is_the_jax_bits():
    module = port_model(tosnet.OSNet025)
    sd = module.state_dict()
    q_state, scales = tq.quantize_params_int8(sd)
    jq_params, jscales = jq.quantize_params_int8(to_flax(module))
    assert q_state.keys() == scales.keys() == sd.keys()
    n_int8 = 0
    for name, q in q_state.items():
        s = scales[name]
        if s is None:
            assert q is sd[name]
            continue
        n_int8 += 1
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        perm = (2, 3, 1, 0) if q.dim() == 4 else (1, 0)
        np.testing.assert_array_equal(q.numpy().transpose(perm),
                                      flax_leaf(jq_params['params'], name))
        np.testing.assert_array_equal(s.numpy().transpose(perm),
                                      flax_leaf(jscales['params'], name))
    assert n_int8 > 20
    deq = tq.dequantize_params(q_state, scales)
    for name in sd:
        if scales[name] is not None:
            assert deq[name].dtype == torch.float32
            assert (deq[name] - sd[name]).abs().max() <= \
                scales[name].max() * 0.5 + 1e-7


def test_make_quantized_apply_matches_jax():
    module = port_model(tosnet.OSNet025)
    x = np.random.default_rng(10).uniform(-2, 2, CROPS).astype(np.float32)
    apply_fn, q_state = tq.make_quantized_apply(module, module.state_dict())
    with torch.no_grad():
        got = apply_fn(q_state, torch.from_numpy(x)).float().numpy()
    japply, jstate = jq.make_quantized_apply(josnet.OSNet025.build(),
                                             to_flax(module))
    want = np.asarray(japply(jstate, jnp.asarray(x)), np.float32)
    assert got.shape == want.shape == (2, 512)
    max_rel, mean_rel = rel(got, want)
    assert max_rel < MAX_REL and mean_rel < MEAN_REL, (max_rel, mean_rel)
    # the module keeps its float weights; the int8 ones live in q_state
    assert all(v.dtype == torch.float32
               for v in module.state_dict().values())
    assert sum(v.dtype == torch.int8 for v in q_state[0].values()) > 20
