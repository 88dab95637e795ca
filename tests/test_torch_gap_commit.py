"""The gap-commit kernel of the port (``csrc/gap_commit.cu``, wrapper
``ops.gap_commit.gap_commit``): RANSAC draws, homography and per-track
similarity RANSAC, Kalman warp/predict/update and the commit of a gap
frame, for every stream of a call.

On the CPU the kernel's own source is built for the host with g++ through
tests/cuda_host_shim.py, the shim the three hand kernels' tests share (a
block's 256 threads as host threads,
``__syncthreads`` as a barrier of all of them, ``__syncwarp``, shuffles
and ballots as meetings of a warp's 32, ``__shared__`` as static storage:
a launch's blocks run in turn, and its launches one after another), under
``-ffp-contract=off`` as the card's build runs under ``-fmad=false``. That
build

- gives, to the bit, every output that the first design of the kernel
  (one block a stream) gave on each synthetic call (``OUTPUT_SHA256``),
  and its block and warp trees pair as that design's did;
- draws JAX's threefry uniforms bit for bit (``ransac_draws_batch``, itself
  held to ``jax.random`` by tests/test_torch_flow.py);
- matches the plain version (``tracker.gap_commit_core``) at 1 and 3
  streams and flow budgets 32 and 48, on a camera homography with 30 %
  outliers, fewer than 4 valid background points, tracks with fewer than 3
  matches, an estimate out of the frame, a track lost by IoS < 0.5 and a
  stream whose tracks are all invalid;
- matches the JAX package's ``_gap_commit_core`` with its own draws.

Tolerances (``assert_commit_close``): booleans equal; H within 0.01 px at
the four frame corners, and the background inliers equal, where the
homography is ok (otherwise the tracker reads neither: the draws of fewer
than 4 valid points give singular 8x8 systems whose float32 garbage
differs between solvers); estimated boxes equal (rounded; the cases keep
them clear of .5); means within 1e-3 px; covariances within 1e-4 of each
track's largest entry; inlier ratios within 1e-6; the rounded boxes equal
where the mean is 1e-3 px clear of a .5 boundary.

The wrapper on CPU tensors is the plain version; it raises on any device
but the CPU and CUDA; its argument checks raise on each fault, and the main
paths' arguments pass them. On the card (marker ``cuda``; they skip
without one, and JAX is imported only by the CPU tests that need it):

    python -m pytest tests/test_torch_gap_commit.py -m cuda
"""
import ctypes
import hashlib

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import kalman as tkf
from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.ops import gap_commit as gc

from .cuda_host_shim import build_host

F32 = np.float32
SIZE = (320, 240)
SPEC_ARGS = dict(size=SIZE, opt_scale=(0.5, 0.5), bg_scale=(0.1, 0.1))
TSPEC = tfk.FlowSpec(**SPEC_ARGS)
T_CAP = ttr.MAX_TRACKS
K = tfk.KP_PER_TRACK
N_BG = 96
AGE_PENALTY, CONFIRM_HITS = 2.0, 2
CASES = ('camera', 'few_bg', 'few_matches', 'out_of_frame', 'lost',
         'all_invalid')
# the camera's motion between the frames
H_CAM = np.array([[1.01, 0.005, 2.3], [-0.004, 0.995, 1.7],
                  [2e-5, -1e-5, 1.0]])
CORNERS = np.array([[0, 0, 1], [SIZE[0] - 1, 0, 1], [0, SIZE[1] - 1, 1],
                    [SIZE[0] - 1, SIZE[1] - 1, 1]], np.float64)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _apply(h, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ h.T
    return p[:, :2] / p[:, 2:]


def stream_inputs(kind, f_cap, seed, n_bg=N_BG):
    """One stream's gap-commit inputs (numpy, the plain version's dtypes)
    for case ``kind``: five tracks translating by (k + 1/4, m + 1/4) px
    with 15 % outlier matches, a sixth whose box depends on the case, an
    inactive seventh (age 3), and ``n_bg`` background points moved by
    H_CAM with 30 % outliers."""
    rng = np.random.default_rng(seed)
    cfg = tkf.KalmanConfig()
    tlbrs = np.zeros((T_CAP, 4), F32)
    for i in range(5):
        x0, y0 = 20 + 48 * i, 30 + 12 * i
        tlbrs[i] = [x0, y0, x0 + 39, y0 + 89]
    tlbrs[5] = {'lost': [300, 100, 359, 199],
                'out_of_frame': [260, 0, 319, 230]}.get(kind,
                                                       [262, 40, 301, 150])
    tlbrs[6] = [100, 180, 139, 235]
    valid = np.arange(T_CAP) < 7
    if kind == 'all_invalid':
        valid[:] = False
    ages = np.zeros(T_CAP, np.int32)
    ages[:7] = [0, 1, 0, 0, 1, 0, 3]
    hits = np.zeros(T_CAP, np.int32)
    hits[:7] = [3, 1, 5, 2, 3, 4, 6]
    lost_pending = np.zeros(T_CAP, bool)
    lost_pending[1] = True
    inl = rng.uniform(0.5, 1.0, T_CAP).astype(F32)
    means, covs = tkf.create(cfg, T(tlbrs))
    means[:, 4:] = T(rng.normal(0, 1.0, (T_CAP, 4)).astype(F32))
    acc, _, trans = tkf.init_mats(cfg, 1 / 30.0)
    means, covs = (a.numpy() for a in tkf.predict(cfg, means, covs, T(trans),
                                                  T(acc)))
    kps = np.stack([rng.uniform(tlbrs[:, 0:1], tlbrs[:, 2:3], (T_CAP, K)),
                    rng.uniform(tlbrs[:, 1:2], tlbrs[:, 3:4], (T_CAP, K))],
                   -1).astype(F32)
    kpv = (rng.uniform(size=(T_CAP, K)) < 0.8) & valid[:, None]
    state = [means, covs, tlbrs, valid, ages, hits,
             np.ones(T_CAP, np.int32), np.zeros(T_CAP, np.int32),
             np.zeros(T_CAP, np.int32), lost_pending, inl, kps, kpv,
             np.zeros((T_CAP, ttr.FEAT_DIM), F32), np.zeros(T_CAP, F32)]

    # gap_points_core's order: active tracks, nearest (largest bottom) first
    active = valid & (ages < 2)
    key = np.where(active, -tlbrs[:, 3] + ages.astype(F32) * 1e-3, np.inf)
    forder = np.argsort(key, kind='stable')[:f_cap]
    f_valid = active[forder]
    f_tlbrs = tlbrs[forder]
    inside = np.concatenate([np.maximum(f_tlbrs[:, :2], 0),
                             np.minimum(f_tlbrs[:, 2:], [SIZE[0] - 1,
                                                         SIZE[1] - 1])], 1)

    trk_prev = np.zeros((f_cap, K, 2))
    trk_cur = np.zeros((f_cap, K, 2))
    trk_ok = np.zeros((f_cap, K), bool)
    for t in range(f_cap):
        if not f_valid[t]:
            continue
        slot = forder[t]
        lo, hi = inside[t, :2] + 2, inside[t, 2:] - 2
        if kind == 'out_of_frame' and slot == 5:
            # a quarter turn about (300, 120): the box's corner leaves the
            # frame while the points stay in it
            c = np.array([300.0, 120.0])
            p = c + rng.uniform(-6, 6, (K, 2))
            q = c + (p - c) @ np.array([[0.0, 1.0], [-1.0, 0.0]])
        else:
            p = rng.uniform(lo, hi, (K, 2))
            q = p + rng.integers(-3, 4, 2) + 0.25
        q = q + rng.normal(0, 0.05, q.shape)
        out = rng.uniform(size=K) < 0.15
        q[out] += rng.uniform(10, 30, (out.sum(), 2)) * rng.choice([-1, 1],
                                                                  (out.sum(),
                                                                   2))
        trk_prev[t], trk_cur[t] = p, q
        trk_ok[t] = rng.uniform(size=K) > 0.05
        if kind == 'few_matches' and t in (1, 3):
            trk_ok[t] = np.arange(K) < 2
    bg_prev = rng.uniform([0, 0], [SIZE[0] - 1, SIZE[1] - 1], (n_bg, 2))
    bg_cur = _apply(H_CAM, bg_prev) + rng.normal(0, 0.3, (n_bg, 2))
    out = rng.uniform(size=n_bg) < 0.3
    bg_cur[out] += rng.uniform(20, 80, (out.sum(), 2)) * rng.choice(
        [-1, 1], (out.sum(), 2))
    bg_ok = rng.uniform(size=n_bg) > 0.05
    if kind == 'few_bg':
        bg_ok = np.arange(n_bg) < 3
    all_prev = np.concatenate([trk_prev.reshape(-1, 2), bg_prev]).astype(F32)
    all_cur = np.concatenate([trk_cur.reshape(-1, 2), bg_cur]).astype(F32)
    status = np.concatenate([trk_ok.reshape(-1), bg_ok])
    return (state, inside.astype(F32), f_tlbrs, f_valid, forder, all_prev,
            all_cur, status)


def case_inputs(kinds, f_cap, seed=0, n_bg=N_BG):
    """[S, ...] torch inputs of the streams ``kinds`` (one case a stream)
    and the shared (trans, acc_cov, frame_tlbr)."""
    streams = [stream_inputs(k, f_cap, seed + 17 * s, n_bg)
               for s, k in enumerate(kinds)]
    states = tuple(T(np.stack([st[0][i] for st in streams]))
                   for i in range(ttr.N_STATE))
    rest = tuple(T(np.stack([st[j] for st in streams])) for j in range(1, 8))
    acc, _, trans = tkf.init_mats(tkf.KalmanConfig(), 1 / 30.0)
    frame = np.array([0, 0, SIZE[0] - 1, SIZE[1] - 1], F32)
    return (states,) + rest, (T(trans), T(acc), T(frame))


def commit_args(kinds, f_cap, seeds, seed=0, n_bg=N_BG):
    """``gap_commit``'s arguments for the streams ``kinds``."""
    (states, inside, f_tlbrs, f_valid, forder, all_prev, all_cur,
     status), (trans, acc, frame) = case_inputs(kinds, f_cap, seed, n_bg)
    return (tkf.KalmanConfig(), TSPEC, AGE_PENALTY, CONFIRM_HITS, states,
            inside, f_tlbrs, f_valid, forder, all_prev, all_cur, status,
            seeds, trans, acc, frame)


def unpack(info, n_bg=N_BG, n_t=T_CAP):
    """A stream's info vector by ``MultiTracker._info_layout``'s names
    (chip_smoke.py phase 17 reads the card's with it)."""
    sizes = {'h_ok': 1, 'h_mat': 9, 'next_tlbrs': 4 * n_t,
             'lost': n_t, 'has_klt': n_t, 'klt_tlbrs': 4 * n_t,
             'new_inl': n_t, 'bg_prev': 2 * n_bg, 'bg_cur': 2 * n_bg,
             'bg_inlier': n_bg, 'est_ok': n_t}
    out, off = {}, 0
    for name, n in sizes.items():
        out[name] = np.asarray(info[off:off + n])
        off += n
    assert off == len(info)
    return out


def assert_commit_close(got, want, tag=''):
    """One stream's (new_state, info) against a reference's, at the
    module's tolerances."""
    (g_state, g_info), (w_state, w_info) = got, want
    g, w = unpack(g_info), unpack(w_info)
    for name in ('h_ok', 'lost', 'has_klt', 'est_ok'):
        np.testing.assert_array_equal(g[name], w[name], err_msg=tag + name)
    if w['h_ok'][0] > 0.5:
        proj = [CORNERS @ np.asarray(x['h_mat'], np.float64).reshape(3, 3).T
                for x in (g, w)]
        corners = [p[:, :2] / p[:, 2:] for p in proj]
        np.testing.assert_allclose(corners[0], corners[1], atol=0.01,
                                   err_msg=tag + 'H at the corners')
        np.testing.assert_array_equal(g['bg_inlier'], w['bg_inlier'],
                                      err_msg=tag + 'bg_inlier')
    for name in ('bg_prev', 'bg_cur', 'klt_tlbrs'):
        np.testing.assert_array_equal(g[name], w[name], err_msg=tag + name)
    np.testing.assert_allclose(g['new_inl'], w['new_inl'], atol=1e-6,
                               err_msg=tag + 'new_inl')
    g_state = [np.asarray(a) for a in g_state]
    w_state = [np.asarray(a) for a in w_state]
    for i in (3, 9, 12, 4, 5, 6, 7, 8, 13, 14):   # booleans, passed through
        np.testing.assert_array_equal(g_state[i], w_state[i],
                                      err_msg=f'{tag}state[{i}]')
    np.testing.assert_array_equal(g_state[11], w_state[11],
                                  err_msg=tag + 'kps')
    np.testing.assert_allclose(g_state[0], w_state[0], atol=1e-3, rtol=0,
                               err_msg=tag + 'means')
    np.testing.assert_allclose(g_state[10], w_state[10], atol=1e-6,
                               err_msg=tag + 'inl')
    scale = np.abs(w_state[1]).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(g_state[1] - w_state[1]) <= 1e-4 * scale), \
        tag + 'covs'
    # the rounded boxes: equal unless the mean sits at a .5 boundary
    frac = np.abs(np.abs(w_state[0][:, :4] - np.floor(w_state[0][:, :4]))
                  - 0.5)
    clear = frac > 1e-3
    for name, g_box, w_box in (('next_tlbrs', g['next_tlbrs'].reshape(-1, 4),
                                w['next_tlbrs'].reshape(-1, 4)),
                               ('tlbrs', g_state[2], w_state[2])):
        assert np.all(np.abs(g_box - w_box) <= 1.0), tag + name
        np.testing.assert_array_equal(g_box[clear], w_box[clear],
                                      err_msg=tag + name)


# The sha256 of each output's bytes (``gap_commit_launch_args``' outputs:
# the 8 written state fields in STATE_OUT order, then the info) that the
# first design of csrc/gap_commit.cu (one block of 256 threads a stream)
# gave, built for the host, on every synthetic call of the host tests:
# (the streams' cases, flow budget, background points), seeds
# HASH_SEEDS[number of streams]. The redesign keeps every sum order, so
# its host build and its card build give them too. (The camera case gives
# the same bytes at budgets 32, 48 and 128: its tracks are the same seven.)
HASH_SEEDS = {1: [11], 3: [5, 2 ** 32 - 1, 77]}
OUTPUT_SHA256 = {
    (('camera',), 32, 96): (
        '27ee17180ac1c40cddd6c0e5c5a47bb1c95478afa2d1f9025d879808798bad30',
        '951ef5baa88da68bd18789f0d932b54238961a246613b73ae5c335784306b893',
        '32552abec4b44fce28aa1c91aa891e1a007fa64e70fb19228b064ad6884ac3af',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '5a04f0e1dba66ea4f471e0e60c4cfb9cd49fbf82d49ebf6af414b5168cb87caa',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        '78a1daf958e0348ba40b009fb6e22dd6c1f825a7ad080625d4486e81df775155',
        'd5f2f9b388278ab9e128825c8f7560f8c35d466d98cc2c0c6a6c08c912b1409d'),
    (('few_bg',), 32, 96): (
        '4898a87aaaf15b2ef4d953aeacf40fa3d7c36aaada477e4eedaddca3b97052b3',
        '702dbc2ba7a7884265cbc7f3465809ffb7a21f938fc8437980236fac9c8ff606',
        '8f822c5bc469db8186c423c34e1b312ea628fe18ef3e7c190c49c828d4e02dc6',
        '38723a2e5e8a17aa7950dc008209944e898f69a7bd10a23c839d341e935fd5ca',
        '38723a2e5e8a17aa7950dc008209944e898f69a7bd10a23c839d341e935fd5ca',
        '5a04f0e1dba66ea4f471e0e60c4cfb9cd49fbf82d49ebf6af414b5168cb87caa',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        'ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7',
        '4bd0ec4764f8986435f48738f8123573444a0c1afcaa62fb832a815ba683f7ef'),
    (('few_matches',), 32, 96): (
        '6e59a40ea113dc3d0b4291721cd99dcf250418b0757c8bed204f430499a642e8',
        'e9dea3975b2f2715b2c00c1263d9c55c90af7ceb438c479ef11ee44363d2c6c0',
        '1410561f99b8012d1fa6eb5d19f9a5f82e5a8aef4b6e28a37efc43e738c80b93',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        'aaa9535c71fe75cacb189869941bdbcef110edf37013f74a217aaf53559257bf',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        '2ced1e588a510c3764a738972b6d9ff069f4932e148e37dbd444eb3dca81570c',
        '2d38aa0bd780498676498ff7f3cabb60aa7241c2081d3c6d25a777405eab8388'),
    (('out_of_frame',), 32, 96): (
        '47896eaa3de33f0955630dd5c7c30241ab33f1d045d5f1dc9c9fd5eefec07188',
        '901e19a91f006f2f66ca60440fbf1e1df61098d939b324e76883142e356948e7',
        'c13dc748c0aca4bcc660284e18a69e0b2d8a27feadb1aa00302062aa30e52030',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '3857e87e634af403d7f8b09f7d2662f17bbcb667cb9476c26dbde3ea0b876e9d',
        '0306dd5f29f984b8b6dc95016528a667b6ca03518f6ec26085175cb20c07a293',
        '59449bd0ae5cd7e1d9ba8a1ddc198fba8547873f49b6c39e33dbb8afb91e9496',
        'e666554fdc32ef1e8e4a0844ba404a0ae09f4e86190f5b8269797c123ddd5be9'),
    (('lost',), 32, 96): (
        '0a486eac7bf52dd0d7b49cb605bd61429986055fd7da2a9b874ab1f45273543d',
        '4f70375dae7737dc641ee7a2becd1b9cb4d77f72e1592cc0ce13d909ba5fcd64',
        '496214575f787ab3e4098020c1be3be28685668d4bfcc56a323cbcc501ae8ae6',
        '103f8f5e0aa2ec1fdf30d636f85cea007a12b71a700d2cbcd94bf96c514a7d51',
        '8bd6f6ec00dbaf70b53ea727850d52492acb599cad07127684bc79c0e36d348c',
        '5dff1bf48fe0b6a1622d3387d823ad2577cf334e410199c88b0ea4512ae126d6',
        'ee0a85198dbfc0dfdcae9866280d7f7f25e76f61bd58ce21c0e08f5dc724a9e4',
        'ea07a518a9d55a6c8f7556f9d051511be6bd826082c8f8c4aec454ca470dc29b',
        '40b21ab3bc038bdf0b5ca915c2487d1a612bc46bc08903faab6b605a505e89c9'),
    (('all_invalid',), 32, 96): (
        '1983acc578a369b9268963da4d1beb5ebcf56ee685f7918c987837d639951d03',
        'd790611dcb37523b944f78bb92737e86329d6359f4e649a651e234e69c23e588',
        'cf6ebf36960a20f0efe3fefb5d179760a99f98713fb284982599f841ccb46c86',
        '38723a2e5e8a17aa7950dc008209944e898f69a7bd10a23c839d341e935fd5ca',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '477d09e10c3d7a0f84444412511080fac174173e243793d1220f7862c8a90bd7',
        '75c4338daaf470b347cea11cde0f9d9e0e12209d501e4f2850f1ce2587669b16',
        'ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7',
        'ee2784e68d84c59bacbc923541d783dd77eee9469c1517a945032f10ebb045e1'),
    (('camera',), 48, 96): (
        '27ee17180ac1c40cddd6c0e5c5a47bb1c95478afa2d1f9025d879808798bad30',
        '951ef5baa88da68bd18789f0d932b54238961a246613b73ae5c335784306b893',
        '32552abec4b44fce28aa1c91aa891e1a007fa64e70fb19228b064ad6884ac3af',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '5a04f0e1dba66ea4f471e0e60c4cfb9cd49fbf82d49ebf6af414b5168cb87caa',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        '78a1daf958e0348ba40b009fb6e22dd6c1f825a7ad080625d4486e81df775155',
        'd5f2f9b388278ab9e128825c8f7560f8c35d466d98cc2c0c6a6c08c912b1409d'),
    (('few_bg',), 48, 96): (
        '4898a87aaaf15b2ef4d953aeacf40fa3d7c36aaada477e4eedaddca3b97052b3',
        '702dbc2ba7a7884265cbc7f3465809ffb7a21f938fc8437980236fac9c8ff606',
        '8f822c5bc469db8186c423c34e1b312ea628fe18ef3e7c190c49c828d4e02dc6',
        '38723a2e5e8a17aa7950dc008209944e898f69a7bd10a23c839d341e935fd5ca',
        '38723a2e5e8a17aa7950dc008209944e898f69a7bd10a23c839d341e935fd5ca',
        '5a04f0e1dba66ea4f471e0e60c4cfb9cd49fbf82d49ebf6af414b5168cb87caa',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        'ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7',
        '4bd0ec4764f8986435f48738f8123573444a0c1afcaa62fb832a815ba683f7ef'),
    (('few_matches',), 48, 96): (
        '6e59a40ea113dc3d0b4291721cd99dcf250418b0757c8bed204f430499a642e8',
        'e9dea3975b2f2715b2c00c1263d9c55c90af7ceb438c479ef11ee44363d2c6c0',
        '1410561f99b8012d1fa6eb5d19f9a5f82e5a8aef4b6e28a37efc43e738c80b93',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        'aaa9535c71fe75cacb189869941bdbcef110edf37013f74a217aaf53559257bf',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        '2ced1e588a510c3764a738972b6d9ff069f4932e148e37dbd444eb3dca81570c',
        '2d38aa0bd780498676498ff7f3cabb60aa7241c2081d3c6d25a777405eab8388'),
    (('out_of_frame',), 48, 96): (
        '47896eaa3de33f0955630dd5c7c30241ab33f1d045d5f1dc9c9fd5eefec07188',
        '901e19a91f006f2f66ca60440fbf1e1df61098d939b324e76883142e356948e7',
        'c13dc748c0aca4bcc660284e18a69e0b2d8a27feadb1aa00302062aa30e52030',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '3857e87e634af403d7f8b09f7d2662f17bbcb667cb9476c26dbde3ea0b876e9d',
        '0306dd5f29f984b8b6dc95016528a667b6ca03518f6ec26085175cb20c07a293',
        '59449bd0ae5cd7e1d9ba8a1ddc198fba8547873f49b6c39e33dbb8afb91e9496',
        'e666554fdc32ef1e8e4a0844ba404a0ae09f4e86190f5b8269797c123ddd5be9'),
    (('lost',), 48, 96): (
        '0a486eac7bf52dd0d7b49cb605bd61429986055fd7da2a9b874ab1f45273543d',
        '4f70375dae7737dc641ee7a2becd1b9cb4d77f72e1592cc0ce13d909ba5fcd64',
        '496214575f787ab3e4098020c1be3be28685668d4bfcc56a323cbcc501ae8ae6',
        '103f8f5e0aa2ec1fdf30d636f85cea007a12b71a700d2cbcd94bf96c514a7d51',
        '8bd6f6ec00dbaf70b53ea727850d52492acb599cad07127684bc79c0e36d348c',
        '5dff1bf48fe0b6a1622d3387d823ad2577cf334e410199c88b0ea4512ae126d6',
        'ee0a85198dbfc0dfdcae9866280d7f7f25e76f61bd58ce21c0e08f5dc724a9e4',
        'ea07a518a9d55a6c8f7556f9d051511be6bd826082c8f8c4aec454ca470dc29b',
        '40b21ab3bc038bdf0b5ca915c2487d1a612bc46bc08903faab6b605a505e89c9'),
    (('all_invalid',), 48, 96): (
        '1983acc578a369b9268963da4d1beb5ebcf56ee685f7918c987837d639951d03',
        'd790611dcb37523b944f78bb92737e86329d6359f4e649a651e234e69c23e588',
        'cf6ebf36960a20f0efe3fefb5d179760a99f98713fb284982599f841ccb46c86',
        '38723a2e5e8a17aa7950dc008209944e898f69a7bd10a23c839d341e935fd5ca',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '477d09e10c3d7a0f84444412511080fac174173e243793d1220f7862c8a90bd7',
        '75c4338daaf470b347cea11cde0f9d9e0e12209d501e4f2850f1ce2587669b16',
        'ad7facb2586fc6e966c004d7d1d16b024f5805ff7cb47c7a85dabd8b48892ca7',
        'ee2784e68d84c59bacbc923541d783dd77eee9469c1517a945032f10ebb045e1'),
    (('camera', 'lost', 'all_invalid'), 32, 96): (
        '77a59278b16667c85df7937d3ac4cff27fdb02393c0c0306c35a395a92d1a10d',
        '8594ca87b66d562ced9c433865dd57e4f53e0baf05a3047a085c1f6ed42f3d77',
        '91b36ee9cf77f4d897b1cb1486bb6e05eb697350a7eeca3973afe991278b18bf',
        '866c9c83e908645f3c9d875ffc745a6b534f1b5233544392ff402baa9473ddb7',
        '4b290af8121dafd11f27bc433acce1c268979831e80eb4a2c86c2a7f9a1c084f',
        'a67864cc8ac0105afe45a47cc8e60ededcac7de23074d02d6aabc0699e7bd93d',
        'af30cc54386f8c450179f929eec0db42bef6ff6a84e2a61e1ba7548056d5622d',
        'c9eb8a233cb6463bf0fd563004a340f21efdf20f621f6c86410355902796c64d',
        'f7ecfb5daa8d424578e610d18ae3fa9e12dcd0c9a9e983cc044e57d7e4f06848'),
    (('few_matches', 'few_bg', 'out_of_frame'), 32, 96): (
        'a33ef7a4e2006e955d055851ff7ccff97c91435751ca9c309ebe4b70ed012cbb',
        '28a8bf0dbd8f914e605017a370a5f850bc2d086eb217280eaeba3870e1fbdc0e',
        '04c1225ffa81f928ba62cee7ac8814cae7df0b931613fce916b7d8e0b7dad4b7',
        'efde0aa27a36d3369dcaf8555897577d6fa9b58ffdb966d1bb9813b50b520c2b',
        '0359718add6341a84b29659396d29d87d2bf7227044b3314f27ee61765d3c4f6',
        '9772c6f532c4fa39b6c7cef812a4068b338af754890c87bcc001bf9b9961cf24',
        'f4ebda08a0b7bf1542f17a377fb1d884776b902e67e9b1dfc00ac8595c239ccf',
        'ea2ce5f1966596489e1882ebb1cd4bf16346b536eae0efcc7e650fd4be7c9893',
        'c9fe1da0718d2ecb3a72247f1d3f5679e03f367566465ab72d0fb4eae3675f47'),
    (('camera', 'lost', 'all_invalid'), 48, 96): (
        '77a59278b16667c85df7937d3ac4cff27fdb02393c0c0306c35a395a92d1a10d',
        '8594ca87b66d562ced9c433865dd57e4f53e0baf05a3047a085c1f6ed42f3d77',
        '91b36ee9cf77f4d897b1cb1486bb6e05eb697350a7eeca3973afe991278b18bf',
        '866c9c83e908645f3c9d875ffc745a6b534f1b5233544392ff402baa9473ddb7',
        '4b290af8121dafd11f27bc433acce1c268979831e80eb4a2c86c2a7f9a1c084f',
        'a67864cc8ac0105afe45a47cc8e60ededcac7de23074d02d6aabc0699e7bd93d',
        'af30cc54386f8c450179f929eec0db42bef6ff6a84e2a61e1ba7548056d5622d',
        'c9eb8a233cb6463bf0fd563004a340f21efdf20f621f6c86410355902796c64d',
        'f7ecfb5daa8d424578e610d18ae3fa9e12dcd0c9a9e983cc044e57d7e4f06848'),
    (('few_matches', 'few_bg', 'out_of_frame'), 48, 96): (
        'a33ef7a4e2006e955d055851ff7ccff97c91435751ca9c309ebe4b70ed012cbb',
        '28a8bf0dbd8f914e605017a370a5f850bc2d086eb217280eaeba3870e1fbdc0e',
        '04c1225ffa81f928ba62cee7ac8814cae7df0b931613fce916b7d8e0b7dad4b7',
        'efde0aa27a36d3369dcaf8555897577d6fa9b58ffdb966d1bb9813b50b520c2b',
        '0359718add6341a84b29659396d29d87d2bf7227044b3314f27ee61765d3c4f6',
        '9772c6f532c4fa39b6c7cef812a4068b338af754890c87bcc001bf9b9961cf24',
        'f4ebda08a0b7bf1542f17a377fb1d884776b902e67e9b1dfc00ac8595c239ccf',
        'ea2ce5f1966596489e1882ebb1cd4bf16346b536eae0efcc7e650fd4be7c9893',
        'c9fe1da0718d2ecb3a72247f1d3f5679e03f367566465ab72d0fb4eae3675f47'),
    (('camera',), 128, 96): (
        '27ee17180ac1c40cddd6c0e5c5a47bb1c95478afa2d1f9025d879808798bad30',
        '951ef5baa88da68bd18789f0d932b54238961a246613b73ae5c335784306b893',
        '32552abec4b44fce28aa1c91aa891e1a007fa64e70fb19228b064ad6884ac3af',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '5a04f0e1dba66ea4f471e0e60c4cfb9cd49fbf82d49ebf6af414b5168cb87caa',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        '78a1daf958e0348ba40b009fb6e22dd6c1f825a7ad080625d4486e81df775155',
        'd5f2f9b388278ab9e128825c8f7560f8c35d466d98cc2c0c6a6c08c912b1409d'),
    (('camera',), 48, 256): (
        'e028e2f3274671677c74201cc79befebc3be7a518342904f8de3c4d8201b43d6',
        '4ea12b009901497f79488a5db53efcac907aa4b5d269c50fa93672ffcfd7de8c',
        '32552abec4b44fce28aa1c91aa891e1a007fa64e70fb19228b064ad6884ac3af',
        '458e696b9c5378470145aedf2e41e638aa1b8433202edc0570931f5fc435f00e',
        '0b1b0c9c7f91eae825ed6fb7702130527ec6894c2dd9e1297624071d8a42687d',
        '5a04f0e1dba66ea4f471e0e60c4cfb9cd49fbf82d49ebf6af414b5168cb87caa',
        '394479be50669288414e55de26077e3e47ca879149a783e3501546d1ea64a274',
        '78a1daf958e0348ba40b009fb6e22dd6c1f825a7ad080625d4486e81df775155',
        '09fa621459b2ac2df2985a931ef6495758a7a65d3e0eff3333e21a4d400f7ae7'),
}


def output_sha256(outputs):
    return tuple(hashlib.sha256(t.cpu().contiguous().numpy().tobytes())
                 .hexdigest() for t in outputs)


def hash_case_args(case):
    kinds, f_cap, n_bg = case
    return commit_args(kinds, f_cap, HASH_SEEDS[len(kinds)], n_bg=n_bg)


def hash_case_id(case):
    kinds, f_cap, n_bg = case
    return f"{'-'.join(kinds)}-{f_cap}-{n_bg}"


def test_cases_are_what_they_say():
    """The plain version on each case: the homography fails where fewer
    than 4 background points are valid and holds elsewhere; tracks with 2
    matches and the turned track get no estimate; the box that is two
    thirds out of the frame is lost (and, being confirmed, pending); a
    stream of invalid tracks keeps nothing; the estimates are clear of
    .5 before their rounding."""
    for kind in CASES:
        args = commit_args([kind], 48, [3])
        new, info = gc.gap_commit_reference(*args)
        u = unpack(info[0])
        assert bool(u['h_ok'][0]) == (kind != 'few_bg'), kind
        est_ok = u['est_ok'].astype(bool)
        forder = args[8][0].numpy()
        if kind == 'camera':
            assert est_ok.sum() == 6, est_ok.nonzero()
            assert u['bg_inlier'].sum() > 40
        if kind == 'few_matches':
            assert not est_ok[forder[1]] and not est_ok[forder[3]]
            assert est_ok.sum() == 4
        if kind == 'out_of_frame':
            assert not est_ok[5] and est_ok.sum() == 5
        if kind == 'lost':
            assert u['lost'][5] and new[9][0, 5] and not new[3][0, 5]
        if kind == 'all_invalid':
            assert not est_ok.any() and not new[3].any()
        if kind == 'few_bg':
            assert not new[3].any() and not new[12].any()
        klt = u['klt_tlbrs'].reshape(-1, 4)[est_ok]
        assert np.all(klt == np.round(klt))


# ---------------------------------------------------------------------------
# The kernel's own source, built for the host
# ---------------------------------------------------------------------------

# Appended to the host build of csrc/gap_commit.cu (the same translation
# unit, so its block tree is in reach): the first design's shared-memory
# trees, the kernel's own tree_sum, and the shim's __syncthreads_count and
# __ballot_sync, each on the blocks of a flat array.
HOST_PROBES = r"""
// every level through shared memory: the first design's block_sum (n =
// kThreads) and its similarity tree (n = 32)
template <int n>
__global__ void shared_tree(const float* x, float* out) {
  __shared__ float red[n];
  const int tid = threadIdx.x;
  red[tid] = x[blockIdx.x * n + tid];
  __syncthreads();
  for (int h = n / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = red[tid] + red[tid + h];
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = red[0];
}
__global__ void block_tree(const float* x, float* out) {
  __shared__ float red[1][kThreads / 2], sum[1];
  float v[1] = {x[blockIdx.x * kThreads + threadIdx.x]};
  tree_sum<1>(v, red, sum);
  if (threadIdx.x == 0) out[blockIdx.x] = sum[0];
}
__global__ void warp_tree(const float* x, float* out) {
  float v = x[blockIdx.x * 32 + threadIdx.x];
  for (int h = 16; h > 0; h >>= 1) v = v + __shfl_down_sync(kFull, v, h);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}
__global__ void count_and_ballot(const int* pred, int* count,
                                 unsigned* ballot) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  count[i] = __syncthreads_count(pred[i]);
  ballot[i] = __ballot_sync(kFull, pred[i]);
}
extern "C" {
void probe_trees(const float* x, float* out, int blocks) {
  host_launch(blocks, kThreads, shared_tree<kThreads>, x, out);
  host_launch(blocks, kThreads, block_tree, x, out + blocks);
  host_launch(blocks * kWarps, 32, shared_tree<32>, x, out + 2 * blocks);
  host_launch(blocks * kWarps, 32, warp_tree, x,
              out + 2 * blocks + blocks * kWarps);
}
void probe_count_and_ballot(const int* pred, int* count, unsigned* ballot,
                            int blocks) {
  host_launch(blocks, kThreads, count_and_ballot, pred, count, ballot);
}
}
"""


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    """csrc/gap_commit.cu built for the host with g++ and the shared shim
    (tests/cuda_host_shim.py: a block's 256 threads as host threads), the
    probes appended, its C entries' signatures declared (ctypes)."""
    # one <<< launch, the draws; the roles launch by cudaLaunchKernelEx
    lib = build_host('gap_commit', tmp_path_factory, extra=HOST_PROBES,
                     opt='-O1')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gap_commit_forward.argtypes = gc.FORWARD_ARGTYPES
    lib.gap_commit_draws.argtypes = [ctypes.POINTER(ctypes.c_uint32), ci, ci,
                                     vp, vp, vp]
    lib.probe_trees.argtypes = [vp, vp, ci]
    lib.probe_count_and_ballot.argtypes = [vp, vp, vp, ci]
    return lib


def host_run(lib, args):
    """One call of the host-built ``gap_commit_forward`` on CPU tensors:
    (new states [S, ...], infos [S, n_info]), as ``gap_commit`` returns
    them."""
    outputs, launch = gc.gap_commit_launch_args(*args)
    assert lib.gap_commit_forward(*launch) == 0
    return gc._new_states(args[4], outputs[:-1]), outputs[-1]


def per_stream(result, s):
    states, infos = result
    return tuple(a[s] for a in states), infos[s]


@pytest.mark.parametrize('f_cap', [32, 48, 128])
def test_host_draws_equal_ransac_draws_bit_for_bit(host_kernel, f_cap):
    """The kernel's threefry uniforms are ``ransac_draws_batch``'s, every
    float32 equal to the bit, for seeds 0, 1, 2^31 - 1, 2^32 - 1 and a
    random one, all in one call (a block each)."""
    seeds = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1,
             int(np.random.default_rng(f_cap).integers(0, 2 ** 32))]
    u_h = torch.empty((5, tfk.HYP_H, 4))
    u_a = torch.empty((5, f_cap, tfk.HYP_A, 2))
    assert host_kernel.gap_commit_draws(
        (ctypes.c_uint32 * 5)(*seeds), 5, f_cap, u_h.data_ptr(),
        u_a.data_ptr(), None) == 0
    want = tfk.ransac_draws_batch(seeds, f_cap, 'cpu')
    for g, w in zip((u_h, u_a), want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize('case', OUTPUT_SHA256, ids=hash_case_id)
def test_host_kernel_outputs_equal_the_first_design(host_kernel, case):
    """Every output of the host build, to the bit, is what the first
    design gave on the same call (``OUTPUT_SHA256``)."""
    args = hash_case_args(case)          # alive while the kernel reads
    outputs, launch = gc.gap_commit_launch_args(*args)
    assert host_kernel.gap_commit_forward(*launch) == 0
    assert output_sha256(outputs) == OUTPUT_SHA256[case]


def test_host_trees_pair_as_the_first_design(host_kernel):
    """The kernel's block tree (``tree_sum``: three levels through shared
    memory, five by ``__shfl_down_sync`` in a warp) and a warp's shuffle
    tree give the shared-memory trees' sums bit for bit, on floats of six
    decades whose sums depend on the order (a sequential sum differs)."""
    rng = np.random.default_rng(4)
    blocks = 6
    x = (rng.normal(size=blocks * 256)
         * 10.0 ** rng.uniform(-3, 3, blocks * 256)).astype(F32)
    out = np.zeros(2 * blocks + 2 * blocks * 8, F32)
    host_kernel.probe_trees(x.ctypes.data, out.ctypes.data, blocks)
    shared, block, shared32, warp = np.split(
        out, [blocks, 2 * blocks, 2 * blocks + 8 * blocks])
    np.testing.assert_array_equal(block.view(np.int32),
                                  shared.view(np.int32))
    np.testing.assert_array_equal(warp.view(np.int32),
                                  shared32.view(np.int32))
    # the same pairs in numpy, and an order that rounds otherwise
    for n, got in ((256, block), (32, warp)):
        tree = x.reshape(-1, n)
        while tree.shape[1] > 1:
            h = tree.shape[1] // 2
            tree = tree[:, :h] + tree[:, h:]
        np.testing.assert_array_equal(got.view(np.int32),
                                      tree[:, 0].view(np.int32))
    seq = np.zeros(blocks, F32)
    for k in range(256):
        seq = seq + x.reshape(blocks, 256)[:, k]
    assert np.any(seq != block)


def test_host_syncthreads_count_and_ballot(host_kernel):
    """``__syncthreads_count`` gives each thread its block's count of
    nonzero predicates; ``__ballot_sync`` each lane its warp's bits."""
    rng = np.random.default_rng(5)
    blocks = 3
    # none, about 30 % and all of a block's predicates nonzero
    share = np.array([[0.0], [0.3], [1.0]])
    pred = ((rng.uniform(size=(blocks, 256)) < share).reshape(-1)
            * rng.integers(1, 9, blocks * 256)).astype(np.int32)
    count = np.zeros(blocks * 256, np.int32)
    ballot = np.zeros(blocks * 256, np.uint32)
    host_kernel.probe_count_and_ballot(
        pred.ctypes.data, count.ctypes.data, ballot.ctypes.data, blocks)
    want = (pred.reshape(blocks, 256) != 0).sum(1)
    np.testing.assert_array_equal(count.reshape(blocks, 256),
                                  np.repeat(want[:, None], 256, 1))
    bits = (pred.reshape(-1, 32) != 0).astype(np.uint64) \
        << np.arange(32, dtype=np.uint64)
    np.testing.assert_array_equal(
        ballot.reshape(-1, 32),
        np.repeat(bits.sum(1).astype(np.uint32)[:, None], 32, 1))


def test_host_scratch_size_is_the_wrappers(host_kernel):
    """The kernel's scratch a stream (``gap_commit_scratch_words``) is
    what the wrapper allocates (``scratch_words``)."""
    for f_cap in (1, 16, 48, 128):
        assert host_kernel.gap_commit_scratch_words(f_cap) \
            == gc.scratch_words(f_cap)


@pytest.mark.parametrize('f_cap', [32, 48])
@pytest.mark.parametrize('kind', CASES)
def test_host_kernel_matches_plain_version(host_kernel, kind, f_cap):
    """One stream of each case: the host build against
    ``tracker.gap_commit_core`` with the same seed's draws."""
    args = commit_args([kind], f_cap, [11])
    assert_commit_close(per_stream(host_run(host_kernel, args), 0),
                        per_stream(gc.gap_commit_reference(*args), 0), kind)


@pytest.mark.parametrize('f_cap', [32, 48])
@pytest.mark.parametrize('kinds', [('camera', 'lost', 'all_invalid'),
                                   ('few_matches', 'few_bg',
                                    'out_of_frame')])
def test_host_kernel_matches_plain_version_three_streams(host_kernel, kinds,
                                                         f_cap):
    """Three streams of different cases and seeds in one call against the
    plain version's batch (``gap_commit_batch``), and each stream equal to
    the bit to its own one-stream call: a stream's result does not depend
    on the others."""
    seeds = [5, 2 ** 32 - 1, 77]
    args = commit_args(kinds, f_cap, seeds)
    got = host_run(host_kernel, args)
    want = gc.gap_commit_reference(*args)
    for s, kind in enumerate(kinds):
        assert_commit_close(per_stream(got, s), per_stream(want, s),
                            f'{kind} (stream {s}): ')
        alone = list(args)
        for i in (4,):
            alone[i] = tuple(a[s:s + 1].contiguous() for a in args[i])
        for i in range(5, 12):
            alone[i] = args[i][s:s + 1].contiguous()
        alone[12] = [seeds[s]]
        one = host_run(host_kernel, alone)
        for g, w in zip(per_stream(got, s)[0], per_stream(one, 0)[0]):
            assert torch.equal(g, w)
        assert torch.equal(got[1][s].view(torch.int32),
                           one[1][0].view(torch.int32))


@pytest.fixture(scope='module')
def jax_commit():
    """The JAX package's jitted ``_gap_commit_core`` and its spec."""
    from fastmot_tpu import kalman as jkf
    from fastmot_tpu import tracker as jtr
    from fastmot_tpu.ops import flow_kernels as jfk
    return jtr, jkf.KalmanConfig(), jfk.FlowSpec(**SPEC_ARGS)


@pytest.mark.parametrize('kind', CASES)
def test_host_kernel_matches_jax(host_kernel, jax_commit, kind):
    """The host build with its own draws against the JAX package's
    ``_gap_commit_core`` on the same state, points and seed: JAX's draws
    and algebra."""
    import jax.numpy as jnp
    jtr, jcfg, jspec = jax_commit
    seed, f_cap = 2 ** 31 + 9, 48
    args = commit_args([kind], f_cap, [seed])
    got = per_stream(host_run(host_kernel, args), 0)
    states = tuple(a[0].numpy() for a in args[4])
    rest = [a[0].numpy() for a in args[5:12]]
    rest[3] = rest[3].astype(np.int32)           # forder as jnp.argsort's
    jstate, jinfo, _ = jtr._gap_commit_kernel(
        jcfg, jspec, AGE_PENALTY, CONFIRM_HITS, states, *rest,
        jnp.uint32(seed), *(a.numpy() for a in args[13:]))
    want = (tuple(np.asarray(a) for a in jstate), np.asarray(jinfo))
    assert_commit_close(got, want, f'{kind} against JAX: ')


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors: one stream is ``gap_commit_core`` with
    ``ransac_draws``, three are ``gap_commit_batch`` with
    ``ransac_draws_batch``, equal to the bit."""
    args = commit_args(['camera'], 48, [9])
    new, info = gc.gap_commit(*args)
    st = tuple(a[0] for a in args[4])
    w_new, w_info = ttr.gap_commit_core(
        *args[:4], st, *(a[0] for a in args[5:12]),
        tfk.ransac_draws(9, 48, 'cpu'), *args[13:])
    assert all(torch.equal(g[0], w) for g, w in zip(new, w_new))
    assert torch.equal(info[0], w_info)
    args = commit_args(['camera', 'lost', 'few_bg'], 32, [1, 2, 3])
    new, info = gc.gap_commit(*args)
    w_new, w_info = ttr.gap_commit_batch(
        *args[:12], tfk.ransac_draws_batch([1, 2, 3], 32, 'cpu'),
        *args[13:])
    assert all(torch.equal(g, w) for g, w in zip(new, w_new))
    assert torch.equal(info, w_info)


def test_wrapper_raises_on_other_devices():
    args = commit_args(['camera'], 32, [0])
    meta = [a.to('meta') if isinstance(a, torch.Tensor) else a for a in args]
    meta[4] = tuple(a.to('meta') for a in args[4])
    with pytest.raises(ValueError, match='unsupported device'):
        gc.gap_commit(*meta)


def _faulty(args, fault):
    """``args`` with one fault of the kind ``fault``."""
    args = list(args)
    states = list(args[4])
    if fault == 'dtype':
        states[4] = states[4].long()
    elif fault == 'shape':
        states[1] = states[1][:, :, :4]
    elif fault == 'contiguous':
        states[0] = torch.cat([states[0], states[0]], -1)[..., ::2]
    elif fault == 'device':
        args[13] = args[13].to('meta')
    elif fault == 'forder':
        args[8] = args[8].int()
    elif fault == 'seeds':
        args[12] = [1, 2]
    elif fault == 'points':
        n_trk = args[6].shape[1] * K
        args[9], args[10] = args[9][:, :n_trk], args[10][:, :n_trk]
        args[11] = args[11][:, :n_trk]
    elif fault == 'many_points':
        extra = torch.zeros((1, 200, 2))
        args[9] = torch.cat([args[9], extra], 1)
        args[10] = torch.cat([args[10], extra], 1)
        args[11] = torch.cat([args[11], torch.ones((1, 200), dtype=bool)], 1)
    elif fault == 'state_fields':
        states = states[:14]
    args[4] = tuple(states)
    return args


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'contiguous', 'device',
                                   'forder', 'seeds', 'points',
                                   'many_points', 'state_fields'])
def test_launch_args_raise_on_each_fault(fault):
    args = commit_args(['camera'], 32, [0])
    gc.gap_commit_launch_args(*args)       # the unbroken call passes
    with pytest.raises(ValueError, match='gap_commit: '):
        gc.gap_commit_launch_args(*_faulty(args, fault))


def test_main_path_arguments_pass_the_kernel_checks(monkeypatch):
    """``MultiTracker.track`` and ``StreamTracker.track`` on the CPU, before
    and after an association frame, hand the wrapper arguments its kernel
    takes (every call checked), one call a tracked frame for all of a
    call's streams."""
    from fastmot_tpu_torch.detector import MAX_DETS, make_detections
    from fastmot_tpu_torch.parallel import StreamTracker
    from .test_torch_flow import textured_frames
    calls = []
    real = gc.gap_commit

    def checked(*args):
        gc.gap_commit_launch_args(*args)
        calls.append(args[4][0].shape[0])
        return real(*args)
    monkeypatch.setattr(gc, 'gap_commit', checked)
    frames = [textured_frames(np.random.default_rng(s),
                              [(0, 0), (2, 1), (4, 2), (6, 3)])
              for s in (0, 1)]
    boxes = np.array([[30, 40, 80, 150], [150, 50, 205, 170]], float)
    dets = make_detections(boxes, np.ones(2, int), np.full(2, 0.9))
    emb = np.random.default_rng(2).normal(size=(2, ttr.FEAT_DIM))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(F32)
    trk = ttr.MultiTracker(SIZE, 'euclidean', device='cpu')
    trk.reset(1 / 30.0)
    trk.init(T(frames[0][0]), dets)
    for i in (1, 2, 3):
        trk.track(T(frames[0][i]), i)
        if i == 2:
            trk.update(i, make_detections(boxes + 4, np.ones(2, int),
                                          np.full(2, 0.9)), emb)
    trk.sync()
    assert len(trk.tracks) == 2
    st = StreamTracker(SIZE, 'euclidean', 2, device='cpu')
    st.reset(1 / 30.0)
    st.init(np.stack([f[0] for f in frames]), [dets, dets])
    tlbr = np.zeros((2, MAX_DETS, 4), F32)
    tlbr[:, :2] = boxes + 4
    valid = np.arange(MAX_DETS)[None].repeat(2, 0) < 2
    d_emb = np.zeros((2, MAX_DETS, ttr.FEAT_DIM), F32)
    d_emb[:, :2] = emb
    for i in (1, 2, 3):
        st.track(np.stack([f[i] for f in frames]), i)
        if i == 2:
            st.update_device(i, tuple(T(a) for a in (
                tlbr, np.where(valid, 1, -1).astype(np.int32),
                np.where(valid, 0.9, 0).astype(F32), valid)), T(d_emb))
    st.sync()
    assert all(len(t.tracks) == 2 for t in st.trackers)
    assert calls == [1, 1, 1, 2, 2, 2]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _to(args, device):
    return [tuple(x.to(device) for x in a) if isinstance(a, tuple) else
            a.to(device) if isinstance(a, torch.Tensor) else a for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize('kinds', [('camera',), ('lost', 'few_bg',
                                                 'out_of_frame'),
                                   ('few_matches', 'all_invalid')])
def test_kernel_matches_plain_version(cuda, kinds):
    """The kernel on the card against the plain version run on the CPU, at
    the module's tolerances, and one launch a call."""
    args = commit_args(kinds, 48, list(range(3, 3 + len(kinds))))
    before = gc.gap_commit.launches
    got = gc.gap_commit(*_to(args, cuda))
    torch.cuda.synchronize()
    assert gc.gap_commit.launches == before + 1
    want = gc.gap_commit_reference(*args)
    got = (tuple(a.cpu() for a in got[0]), got[1].cpu())
    for s, kind in enumerate(kinds):
        assert_commit_close(per_stream(got, s), per_stream(want, s), kind)


@pytest.mark.cuda
@pytest.mark.parametrize('case', OUTPUT_SHA256, ids=hash_case_id)
def test_kernel_outputs_equal_the_first_design(cuda, case):
    """Every output of the card's kernel, through the wrapper, to the
    bit, is what the first design's host build gave (``OUTPUT_SHA256``)."""
    new, info = gc.gap_commit(*_to(hash_case_args(case), cuda))
    assert output_sha256([new[i] for i in gc.STATE_OUT] + [info]) \
        == OUTPUT_SHA256[case]


@pytest.mark.cuda
@pytest.mark.parametrize('f_cap', [16, 48, 128])
def test_kernel_draws_equal_ransac_draws(cuda, f_cap):
    seeds = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 123456789]
    got = gc.kernel_draws(seeds, f_cap, cuda)
    want = tfk.ransac_draws_batch(seeds, f_cap, 'cpu')
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_kernel_is_repeatable_and_raises_on_bad_arguments(cuda):
    args = _to(commit_args(['camera', 'lost'], 48, [4, 5]), cuda)
    a = gc.gap_commit(*args)
    b = gc.gap_commit(*args)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match='gap_commit: '):
        gc.gap_commit(*_faulty(args, 'dtype'))
