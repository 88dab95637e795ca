"""The association costs kernel of the port (``csrc/assoc_costs.cu``,
wrapper ``ops.assoc_costs.assoc_costs`` behind ``tracker.assoc_costs_core``
and ``tracker.assoc_costs_batch`` on the card, plain version
``tracker.assoc_costs_reference``): every cascade stage's cost matrix and
row mask of a call's streams in one launch.

On the CPU:

- the plain version against the JAX package's ``_assoc_costs_core``
  (``vmap`` over streams): every mask and the occlusion equal, the IoU
  cost within 1e-6, the fused and reID costs within ``JAX_ATOL`` (JAX
  solves the Mahalanobis distance through its unrolled Cholesky and sums
  its products in XLA's order);
- the kernel's own source built for the host with g++ through
  tests/cuda_host_shim.py (the blocks in turn on a team of 256 host
  threads, the launch's own): every mask, the occlusion, the IoU cost and
  every gate's decision (where an entry is 1e5) bit for bit the plain
  version's; the appearance and the fused costs within ``COST_ATOL`` of
  it, the reID costs within ``REID_ATOL``; on seeded cases (tracks on
  their detections and apart, overlapping and occluded detections, tracks
  with no features, a full history, the embedding budget, three streams,
  the cosine metric, the appearance given as on the split path, and the
  main path's full width: 128 tracks, 128 detections, 64 history rows,
  512 features); every output's sha256 as the first design gave it
  (``OUTPUT_SHA256``); cases at the kernels' edges (``EDGE_CASES``:
  ragged row, detection and feature counts, the split path and the cosine
  metric at such sizes) against the plain version and the sha256 a host
  build of the first design's source gave (``EDGE_SHA256``); one stream
  without the stream axis equal to a batched call's; and the cascade,
  the finals and the commit fed the host build's costs give the same
  integer outputs as fed the plain version's.

On the card (marker ``cuda``; they skip without one):

    python -m pytest tests/test_torch_assoc_costs.py -m cuda
"""
import hashlib
from collections import namedtuple

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import kalman as tkf
from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.kalman import KalmanConfig
from fastmot_tpu_torch.ops import assoc_costs as acost
from fastmot_tpu_torch.ops import distance as dist
from fastmot_tpu_torch.ops.distance import Metric

from .cuda_host_shim import build_host

F32 = np.float32
Case = namedtuple('Case', 'streams tracks dets hist features emb_cap metric '
                         'given max_assoc confirm')
# each case: 'capped' lets the fill of empty entries through the cost gate;
# 'stage1' is chip_smoke.py's stage1_cost regime (64 live tracks near 40
# detections on a 1280 x 720 field, appearance nearly constant, hits 0-5
# against 3 to confirm) at the main path's width
CASES = {'frame': Case(1, 32, 32, 16, 64, None, 'euclidean', False, 0.9, 1),
         'streams': Case(3, 32, 24, 16, 48, None, 'euclidean', False, 0.9,
                         1),
         'capped': Case(1, 32, 32, 16, 64, 20, 'euclidean', False, 1.5, 1),
         'cosine': Case(2, 32, 32, 16, 64, None, 'cosine', False, 0.9, 1),
         'split': Case(2, 32, 32, 16, 64, None, 'euclidean', True, 0.9, 1),
         'full_width': Case(1, 128, 128, 64, 512, 64, 'euclidean', False,
                            0.9, 1),
         'stage1': Case(1, 128, 128, 64, 512, None, 'euclidean', False, 0.9,
                        3)}
CASE_SEEDS = {kind: i + 1 for i, kind in enumerate(CASES)}
# cases at the kernels' edges: tracks and history rows not a multiple of a
# tile's 16, detections not a multiple of a tile's 16 or a prep block's
# 32, features not a multiple of 64 or of a staged chunk's 128 (300: three
# chunks, the last partial), nor of 4 (50: the copies a float at a time),
# more than one pass of the prep's 1,024 and more chunks than the tile's 4
# stages (1,100), the embedding budget, the split path's given distances
# and the cosine metric at such sizes
EDGE_CASES = {
    'ragged': Case(2, 20, 45, 13, 300, None, 'euclidean', False, 0.9, 1),
    'narrow': Case(1, 37, 19, 5, 50, 12, 'euclidean', False, 1.5, 1),
    'split_ragged': Case(2, 20, 45, 13, 100, None, 'euclidean', True, 0.9,
                         1),
    'cosine_ragged': Case(1, 33, 70, 17, 300, None, 'cosine', False, 0.9,
                          1),
    'wide': Case(1, 20, 13, 5, 1100, None, 'euclidean', False, 0.9, 1)}
CASE_SEEDS.update({kind: 20 + i for i, kind in enumerate(EDGE_CASES)})
ALL_CASES = {**CASES, **EDGE_CASES}
# assoc_costs_core's scalars as MultiTracker passes them (its defaults;
# cfg/mot.json's max_age 6: 4 depth masks)
N_DEPTH, MOTION_W, IOU_GATE = 4, 0.2, 0.6
FILL, OCCLUSION = 1.0, 0.7
# the kernel against the plain version. The euclidean distance is
# sqrt(|a|^2 + |b|^2 - 2 a.b), whose three sums of 512 products round
# apart in other orders: the squared distances agree within SQ_ATOL
# (1.55e-6 read, on the seeded cases at four seeds each and on
# chip_smoke.py phase 21's cases on an H100), so a distance d within
# sqrt(d^2 + SQ_ATOL) - d (1.4e-3 at d = 0, as between the main path's
# random-weight embeddings; 1.6e-5 at the 'stage1' case's d = 0.064);
# beyond that, COST_ATOL and REID_ATOL (7.5e-7 and 4.8e-7 read: the
# Mahalanobis term, the cosine metric)
SQ_ATOL, COST_ATOL, REID_ATOL = 2e-6, 2e-6, 2e-6
# the plain version against JAX
JAX_ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def unit(rng, n, f):
    v = rng.normal(0, 1, (n, f))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def one_stream(rng, t, d, h, f):
    """One stream's (state, hist, dets, emb), numpy: tracks in a 640 x 480
    field with Kalman covariances (create, then 1-4 predictions), their
    averaged features; detections on about half of the valid tracks (a
    few pixels off, embeddings near the track's feature), pairs where one
    box holds most of another (occluded at IoS 0.7), free ones; tracks
    with no features; a history whose rows are mostly valid."""
    cfg = KalmanConfig()
    n_valid = (3 * t) // 4
    valid = np.zeros(t, bool)
    valid[rng.permutation(t)[:n_valid]] = True
    xy = rng.uniform([0, 0], [560, 380], (t, 2))
    wh = rng.uniform(20, 90, (t, 2)) * np.array([0.6, 1.5])
    boxes = np.round(np.concatenate([xy, xy + wh], 1)).astype(F32)
    acc, _, trans = tkf.init_mats(cfg, 1 / 30.0)
    mean, cov = tkf.create(cfg, T(boxes))
    for _ in range(int(rng.integers(1, 5))):
        mean, cov = tkf.predict(cfg, mean, cov, T(trans), T(acc))
    means = mean.numpy() + np.concatenate(
        [rng.normal(0, 1.5, (t, 4)), np.zeros((t, 4))], 1).astype(F32)
    covs = cov.numpy()
    tlbrs = np.round(means[:, :4]).astype(F32)
    ages = rng.integers(0, 9, t).astype(np.int32)
    hits = rng.integers(0, 4, t).astype(np.int32)
    labels = np.where(valid, rng.integers(0, 2, t), -2).astype(np.int32)
    feats = unit(rng, t, f)
    feat_count = rng.integers(0, 5, t).astype(F32)
    feat_count[rng.permutation(t)[:t // 8]] = 0.0         # no features
    feat_sum = (feats * feat_count[:, None]).astype(F32)
    z = np.zeros(t, np.int32)
    state = [means.astype(F32), covs.astype(F32), tlbrs, valid, ages, hits,
             labels, z, z, np.zeros(t, bool), np.ones(t, F32),
             np.zeros((t, 4, 2), F32), np.zeros((t, 4), bool), feat_sum,
             feat_count]

    h_feats = unit(rng, h, f)
    h_count = rng.integers(0, 5, h).astype(F32)
    hist = [(h_feats * np.maximum(h_count, 1)[:, None]).astype(F32),
            h_count, rng.integers(0, 2, h).astype(np.int32),
            rng.uniform(size=h) < 0.9, np.zeros(h, np.int32),
            np.zeros(h, np.int32)]

    on = rng.permutation(np.flatnonzero(valid))[:min(n_valid // 2, d // 2)]
    n_on = len(on)
    d_tlbrs = np.zeros((d, 4), F32)
    d_tlbrs[:n_on] = tlbrs[on] + np.round(rng.normal(0, 2, (n_on, 4)))
    emb = np.zeros((d, f))
    emb[:n_on] = feats[on] + rng.normal(0, 0.05, (n_on, f))
    rest = d - n_on
    dxy = rng.uniform([0, 0], [580, 400], (rest, 2))
    dwh = rng.uniform(20, 70, (rest, 2))
    d_tlbrs[n_on:] = np.round(np.concatenate([dxy, dxy + dwh], 1))
    emb[n_on:] = rng.normal(0, 1, (rest, f))
    # occluded pairs: a box inside a larger one
    for a in range(n_on, min(d - 1, n_on + 6), 2):
        big = d_tlbrs[a]
        d_tlbrs[a + 1] = big + np.array([4, 6, -4, -6], F32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    d_valid = np.arange(d) < d - 2
    d_labels = np.where(d_valid, np.concatenate(
        [labels[on], rng.integers(0, 2, rest)]), -1).astype(np.int32)
    d_labels[~d_valid] = -1
    d_conf = np.where(d_valid, rng.uniform(0.3, 1, d), 0).astype(F32)
    perm = rng.permutation(d)
    dets = [d_tlbrs[perm], d_labels[perm], d_conf[perm], d_valid[perm]]
    return state, hist, dets, emb[perm].astype(F32)


def stage1_stream(rng, t, d, h, f, t_live=64, d_live=40):
    """One stream of the 'stage1' case, numpy (as ``one_stream``): tracks
    within a dozen pixels of the first ``d_live`` detections and the rest
    anywhere, every feature near one direction (appearance distances tie
    within 1e-3), hits 0-5, ages 0-7."""
    state, hist, dets, emb = one_stream(rng, t, d, h, f)
    cx = rng.uniform(60, 1200, d_live)
    cy = rng.uniform(60, 640, d_live)
    wh = rng.uniform([30, 70], [60, 140], (d_live, 2))
    box = np.stack([cx, cy, cx + wh[:, 0], cy + wh[:, 1]], 1)
    d_tlbrs = np.zeros((d, 4))
    d_tlbrs[:d_live] = np.round(box)
    tb = np.zeros((t, 4))
    tb[:d_live] = box + np.tile(rng.normal(0, 12, (d_live, 2)), 2)
    free = rng.uniform([0, 0], [1200, 600], (t_live - d_live, 2))
    tb[d_live:t_live] = np.concatenate([free, free + [40, 100]], 1)
    means = state[0].copy()
    means[:, :4] = tb
    state[0] = means.astype(F32)
    state[2] = np.round(tb).astype(F32)
    state[3] = np.arange(t) < t_live
    state[4] = rng.integers(0, 8, t).astype(np.int32)
    state[5] = rng.integers(0, 6, t).astype(np.int32)
    state[6] = np.where(state[3], 1, -2).astype(np.int32)
    base = unit(rng, 1, f)
    state[13] = (base + rng.normal(0, 2e-3, (t, f))).astype(F32) \
        * np.maximum(state[14], 1)[:, None]
    valid = np.arange(d) < d_live
    emb = (base + rng.normal(0, 2e-3, (d, f))).astype(F32)
    dets = [d_tlbrs.astype(F32), np.where(valid, 1, -1).astype(np.int32),
            np.where(valid, 0.9, 0).astype(F32), valid]
    return state, hist, dets, emb


def costs_case(kind, seed, streams=None):
    """(states, hists, dets, embs) with a leading stream axis (``streams``
    of them in place of the case's own count: chip_smoke.py phase 21's 8
    streams), numpy."""
    c = ALL_CASES[kind]
    rng = np.random.default_rng(seed)
    make = stage1_stream if kind == 'stage1' else one_stream
    streams = [make(rng, c.tracks, c.dets, c.hist, c.features)
               for _ in range(streams or c.streams)]
    return tuple(tuple(np.stack(x) for x in zip(*(st[g] for st in streams)))
                 if g != 3 else np.stack([st[3] for st in streams])
                 for g in range(4))


def params(kind):
    c = ALL_CASES[kind]
    return (KalmanConfig(), Metric[c.metric.upper()], N_DEPTH, MOTION_W,
            c.max_assoc, IOU_GATE, FILL, OCCLUSION, c.confirm)


def torch_case(case, device='cpu'):
    states, hists, dets, embs = case
    return (tuple(T(a).to(device) for a in states),
            tuple(T(a).to(device) for a in hists),
            tuple(T(a).to(device) for a in dets), T(embs).to(device))


def given_appearance(kind, case):
    """The two appearance distances the split path hands the kernel
    (``split_feature_dists`` with one slice: an identity all-reduce)."""
    if not ALL_CASES[kind].given:
        return None
    states, hists, _, embs = case
    return ttr.split_feature_dists(Metric.EUCLIDEAN, states[13], states[14],
                                   hists[0], hists[1], embs, lambda x: None)


def plain(kind, case, app=None):
    """``assoc_costs_reference`` under ``vmap`` over the streams (on the
    split path's case with ``app``, or the distances ``case`` gives)."""
    states, hists, dets, embs = case
    emb_cap = ALL_CASES[kind].emb_cap
    app = given_appearance(kind, case) if app is None else app
    p = params(kind)

    def one(state, hist, det, emb, *a):
        return ttr.assoc_costs_reference(*p, state, hist, *det, emb,
                                         emb_cap=emb_cap,
                                         appearance=a or None)
    return torch.func.vmap(one)(states, hists, dets, embs,
                                *(app if app is not None else ()))


def flat(result):
    """The costs tuple's tensors in order, the depth masks spread."""
    out = []
    for x in result:
        out.extend(x if isinstance(x, tuple) else (x,))
    return out


NAMES = (['cost', 'iou_cost', 'reid_cost', 'occluded', 'h_reid_ok']
         + [f'depth_mask_{i}' for i in range(N_DEPTH)]
         + ['base_iou_active', 'base_unconfirmed', 'd_valid', 'col4row0'])
EXACT = [n for n in NAMES if n not in ('cost', 'reid_cost')]


def output_sha256(result):
    h = hashlib.sha256()
    for t in flat(result):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# each edge case's outputs as a host build of the first design's source
# (commit 1fcedb2's csrc/assoc_costs.cu) gave them
EDGE_SHA256 = {
    'ragged':
        '6871a61b3fc6e2ce12a708c1dd97428e0d4501460548ed5a4d49829617ed25e4',
    'narrow':
        '46993369baae048e47287030a8b07cb61bc1c42db3ebbccc23f7ab45201db2f4',
    'split_ragged':
        '86fabdde4215beb97d219ba81bf0e131d98f28af16251cd5204e757eea27e1f2',
    'cosine_ragged':
        '9da69acf0dca479876d2231c159627182444df629eeb88ae4cc7a348d1c79358',
    'wide':
        'c26f094e54b806a4415fd09f3192933fc095ac97a3caea9a68c55b7910afbe61',
}
# every seeded case's outputs as the first design of the kernel gave them
OUTPUT_SHA256 = {
    'frame':
        '125ab6d3e914119a17a7f88f07250e99fa01c42d855d9358c3dbf57bd5d1390b',
    'streams':
        'aa303913f8be476a762f045ee50f46e5736decdb990f86f8d010503ac36c8823',
    'capped':
        'f02579f2c4d533ce216374502d040f37d3ac649b151b299c209c2dad67f436c6',
    'cosine':
        '67cddcefff349393d6eead2b978c91c17a27b5ae651cd3176f7b608593a39efe',
    'split':
        'a9d59ee468a63f340667938a53a2f90c8cc777fd5f94c413265078562be73fd3',
    'full_width':
        '1c08d5825664a2c5d20a93c9953a2365bfa851fad748ecd01e8eada7a3acc503',
    'stage1':
        'e0dcdde3a81cac3dbbceb2e4e8b153b6dc0932c83ef3910a6916ae0e1eb1792d',
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six workers on the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    return acost.declare(build_host('assoc_costs', tmp_path_factory))


def host_costs(lib, kind, case, device='cpu', app=None):
    """``assoc_costs`` through the host build (or the card's library on
    CUDA tensors), the plain version's tuple; on the split path's case
    with ``app``, or the distances ``case`` gives."""
    states, hists, dets, embs = case
    if device == 'cpu':
        lib.set_host_threads(0)
    outputs, args, _ = acost.assoc_costs_launch_args(
        *params(kind), states, hists, dets, embs, ALL_CASES[kind].emb_cap,
        given_appearance(kind, case) if app is None else app, lib=lib)
    assert lib.assoc_costs_forward(*args) == 0
    cost, iou_cost, reid, occluded, h_reid_ok, masks, col4row = outputs
    return (cost, iou_cost, reid, occluded, h_reid_ok,
            tuple(masks[:N_DEPTH]), masks[N_DEPTH], masks[N_DEPTH + 1],
            dets[3], col4row)


def plain_appearance(kind, case, app=None):
    """The plain version's unmasked appearance distances ``(t_app [S, T,
    D], h_app [S, H, D])`` (``app``, or the case's split-path ones)."""
    if app is not None or ALL_CASES[kind].given:
        return app if app is not None else given_appearance(kind, case)
    states, hists, _, embs = case
    metric = Metric[ALL_CASES[kind].metric.upper()]

    def one(f_sum, count, emb):
        return dist.cdist(ttr.normalized_feats(f_sum, count), emb, metric)
    return (torch.func.vmap(one)(states[13], states[14], embs),
            torch.func.vmap(one)(hists[0], hists[1], embs))


def assert_costs_close(got, want, tag, app, weight=1.0 - MOTION_W,
                       euclidean=True):
    """``got`` against ``want`` at this file's rules, ``app`` the plain
    version's appearance distances (``plain_appearance``): the exact
    outputs equal, the same entries gated, the fused and reID costs within
    their bounds (``weight`` the appearance's in the fused cost). Returns
    the largest differences of the cost and the reID cost, and the largest
    difference of the squared appearance distances they imply ('sq')."""
    g, w = dict(zip(NAMES, flat(got))), dict(zip(NAMES, flat(want)))
    for name in EXACT:
        assert torch.equal(g[name].cpu(), w[name].cpu()), f'{tag}: {name}'
    empty = w['occluded'].cpu()[..., None, :].expand(w['cost'].shape)
    err = {}
    for name, atol, scale, d in (
            ('cost', COST_ATOL, weight, app[0].cpu()),
            ('reid_cost', REID_ATOL, 1.0, app[1].cpu())):
        a, b = g[name].cpu(), w[name].cpu()
        gated = b == 1e5
        assert torch.equal(a == 1e5, gated), f'{tag}: {name} gates'
        bound = torch.full_like(b, atol)
        if euclidean:
            bound = bound + scale * (torch.sqrt(d * d + SQ_ATOL) - d)
        if name == 'cost':       # a filled entry carries no distance
            bound = torch.where(empty, atol, bound)
        diff = (a - b).abs()
        assert bool((diff <= bound)[~gated].all()), \
            f'{tag}: {name} off by {float(diff[~gated].max())}'
        err[name] = float(diff[~gated].max()) if bool((~gated).any()) \
            else 0.0
        # the squared distance each side implies (the motion term's share
        # of a fused entry's difference taken as the appearance's)
        live = ~gated if name == 'reid_cost' else ~gated & ~empty
        if bool(live.any()):
            d_got = d + (a - b) / scale
            sq = (d_got * d_got - d * d).abs()[live]
            err['sq'] = max(err.get('sq', 0.0), float(sq.max()))
    return err


def test_cases_are_what_they_say():
    """The cases gate and fill entries, occlude detections, and leave
    entries both sides of the Mahalanobis gate and the cost gate."""
    for kind in CASES:
        res = plain(kind, torch_case(costs_case(kind, CASE_SEEDS[kind])))
        cost, iou, reid, occluded = res[:4]
        live = (cost < 1e5)
        assert int(live.sum()) > 3, kind
        assert int((cost == 1e5).sum()) > 3, kind
        assert bool(occluded.any()) == (kind != 'stage1'), kind
        assert int((iou < 1e5).sum()) > 3 and int((reid < 1e5).sum()) > 3
        if kind == 'capped':
            assert bool(occluded[..., 20:].all())
            # filled entries (1.0, fused with the motion term) pass the gate
            assert bool(((cost > 0.8) & (cost < 1e5)).any())


@pytest.mark.parametrize('kind', list(CASES))
def test_host_build_matches_plain_version(host_kernel, kind):
    case = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    assert_costs_close(host_costs(host_kernel, kind, case),
                       plain(kind, case), kind, plain_appearance(kind, case),
                       euclidean=ALL_CASES[kind].metric == 'euclidean')


@pytest.mark.parametrize('kind', list(CASES))
def test_host_outputs_equal_the_first_design(host_kernel, kind):
    case = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    assert output_sha256(host_costs(host_kernel, kind, case)) \
        == OUTPUT_SHA256[kind]


def test_edge_cases_are_what_they_say():
    """The edge cases' sizes are what their comment says, and they gate,
    fill and occlude."""
    for kind, c in EDGE_CASES.items():
        assert c.tracks % 16 and c.hist % 16 and c.dets % 16, kind
        assert c.features % 64, kind
        res = plain(kind, torch_case(costs_case(kind, CASE_SEEDS[kind])))
        cost, _, reid, occluded = res[:4]
        assert int((cost < 1e5).sum()) > 3 and int((reid < 1e5).sum()) > 3
        assert int((cost == 1e5).sum()) > 3 and bool(occluded.any()), kind
    assert EDGE_CASES['narrow'].features % 4
    assert EDGE_CASES['ragged'].features > 2 * 128


@pytest.mark.parametrize('kind', list(EDGE_CASES))
def test_host_build_at_the_edges(host_kernel, kind):
    """The plain version at this file's rules, and the first design's
    outputs bit for bit."""
    case = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    got = host_costs(host_kernel, kind, case)
    assert_costs_close(got, plain(kind, case), kind,
                       plain_appearance(kind, case),
                       euclidean=ALL_CASES[kind].metric == 'euclidean')
    assert output_sha256(got) == EDGE_SHA256[kind]


def test_one_stream_without_the_stream_axis(host_kernel):
    """One stream's tensors without the stream axis (as
    ``tracker.assoc_costs_core`` passes them): the batched call's stream
    0, bit for bit, and outputs without the axis."""
    kind = 'streams'
    case = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    states, hists, dets, embs = case
    want = host_costs(host_kernel, kind, case)
    host_kernel.set_host_threads(0)
    outputs, args, _ = acost.assoc_costs_launch_args(
        *params(kind), tuple(a[0] for a in states),
        tuple(a[0] for a in hists), tuple(a[0] for a in dets), embs[0],
        lib=host_kernel)
    assert host_kernel.assoc_costs_forward(*args) == 0
    cost, iou_cost, reid, occluded, h_reid_ok, masks, col4row = outputs
    got = (cost, iou_cost, reid, occluded, h_reid_ok,
           tuple(masks[:N_DEPTH]), masks[N_DEPTH], masks[N_DEPTH + 1],
           dets[3][0], col4row)
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == w.shape[1:] and torch.equal(g, w[0])


def test_scratch_layout_agrees(host_kernel):
    """The kernel's scratch (``assoc_costs_scratch_words``) is the rows'
    normalised features [S, T + H, F] (with the products), their squared
    norms [S, T + H], the tracks' factors and means [S, T, 16] and the
    embeddings' squared norms [S, D], each to a multiple of 4 floats; the
    wrapper's allocation holds that much past the outputs."""
    def r4(n):
        return (n + 3) // 4 * 4
    for s, t, d, h, f, products in (
            (1, 128, 128, 64, 512, True), (2, 20, 45, 13, 300, True),
            (3, 7, 9, 5, 50, False), (8, 128, 128, 64, 512, False)):
        rows = s * (t + h)
        assert host_kernel.assoc_costs_scratch_words(
            s, t, d, h, f, products) == (r4(rows * f) if products else 0) \
            + r4(rows) + s * t * 16 + r4(s * d)
    kind = 'streams'
    states, hists, dets, embs = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    s, t, h, f = *states[0].shape[:2], *hists[0].shape[1:]
    outputs, args, inputs = acost.assoc_costs_launch_args(
        *params(kind), states, hists, dets, embs, lib=host_kernel)
    buf, scratch = inputs[-1], args[0][-1]
    words = host_kernel.assoc_costs_scratch_words(s, t, dets[0].shape[1], h,
                                                  f, True)
    assert scratch >= max(x.data_ptr() + x.numel() * x.element_size()
                          for x in outputs)
    assert buf.data_ptr() + 4 * buf.numel() >= scratch + 4 * words


def downstream(kind, costs, case):
    """The cascade, the finals and the commit of one stream fed ``costs``:
    their integer outputs (col4row, u_det_conf, reid_c4r, rect_c4r, and the
    commit's integer state, history and info)."""
    states, hists, dets, embs = case
    confirm = ALL_CASES[kind].confirm
    (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
     base_ia, base_u, u_det, col4row) = costs
    u2, c2 = ttr.stages_scan_core(N_DEPTH, cost, iou_cost, depth_masks,
                                  base_ia, base_u, u_det, col4row, eps=1e-4)
    finals = ttr.finals_reference(0.5, 0.45, 0.2, confirm, states[2],
                                  states[3], states[4], states[5], dets[0],
                                  dets[2], reid_cost, h_reid_ok, occluded,
                                  u2, c2)
    out = [c2] + list(finals)
    cascade_out = (occluded[0], c2[0]) + tuple(x[0] for x in finals)
    new_state, new_hist, info = ttr.commit_part(
        KalmanConfig(), confirm, 6, 50, tuple(a[0] for a in states),
        tuple(a[0] for a in hists), *(a[0] for a in dets), embs[0], 37,
        T(np.array([0, 0, 639, 479], F32)), cascade_out)
    out += [a for a in new_state if not a.is_floating_point()]
    out += [a for a in new_hist if not a.is_floating_point()]
    return out


@pytest.mark.parametrize('kind', ['frame', 'full_width', 'stage1'])
def test_downstream_integers_agree(host_kernel, kind):
    """The cascade, the finals and the commit give the same integer
    outputs from the host build's costs as from the plain version's."""
    case = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    got = downstream(kind, host_costs(host_kernel, kind, case), case)
    want = downstream(kind, plain(kind, case), case)
    assert int((want[0] >= 0).sum()) > 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_version_matches_jax():
    """``assoc_costs_reference`` against the JAX package's
    ``_assoc_costs_core`` on the seeded cases computed in place (the split
    path's given distances are the port's own)."""
    import jax
    import jax.numpy as jnp
    from fastmot_tpu import tracker as jtr
    from fastmot_tpu.kalman import KalmanConfig as JCfg
    from fastmot_tpu.ops.distance import Metric as JMetric
    for kind in ('frame', 'streams', 'capped', 'cosine'):
        case = costs_case(kind, CASE_SEEDS[kind] + 10)
        states, hists, dets, embs = case
        c = ALL_CASES[kind]

        def one(state, hist, det, emb):
            return jtr._assoc_costs_core(
                JCfg(), JMetric[c.metric.upper()], N_DEPTH, MOTION_W,
                c.max_assoc, IOU_GATE, FILL, OCCLUSION, c.confirm, state,
                hist, *det, emb, emb_cap=c.emb_cap)
        want = jax.vmap(one)(*(tuple(jnp.asarray(a) for a in x)
                               if isinstance(x, tuple) else jnp.asarray(x)
                               for x in case))
        want = dict(zip(NAMES, [np.asarray(a) for a in flat(
            tuple(tuple(m) if isinstance(m, (tuple, list)) else m
                  for m in want))]))
        got = dict(zip(NAMES, [a.numpy() for a in flat(
            plain(kind, torch_case(case)))]))
        for name in EXACT:
            if name == 'iou_cost':
                np.testing.assert_allclose(got[name], want[name], rtol=0,
                                           atol=1e-6, err_msg=kind)
            else:
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=f'{kind} {name}')
        for name in ('cost', 'reid_cost'):
            np.testing.assert_array_equal(got[name] == 1e5,
                                          want[name] == 1e5, err_msg=kind)
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=JAX_ATOL, err_msg=kind)


def test_tracker_routes_on_the_cpu_to_the_plain_version(monkeypatch):
    """``assoc_costs_core`` and ``assoc_costs_batch`` on CPU tensors run
    the plain version and never load the kernel."""
    monkeypatch.setattr(acost, 'assoc_costs_library', lambda: pytest.fail(
        'the kernel library was loaded for CPU tensors'))
    case = torch_case(costs_case('frame', 1))
    states, hists, dets, embs = case
    want = plain('frame', case)
    batch = ttr.assoc_costs_batch(params('frame'), states, hists, dets, embs)
    single = ttr.assoc_costs_core(*params('frame'),
                                  tuple(a[0] for a in states),
                                  tuple(a[0] for a in hists),
                                  *(a[0] for a in dets), embs[0])
    for a, b, c in zip(flat(batch), flat(want), flat(single)):
        assert torch.equal(a, b) and torch.equal(c, b[0])
    assert acost.assoc_costs.launches == 0
    with pytest.raises(ValueError, match='unsupported device'):
        acost.assoc_costs(*params('frame'), states, hists, dets, embs)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'detections',
                                   'appearance'])
def test_launch_args_raise_on_each_fault(fault):
    states, hists, dets, embs = torch_case(costs_case('frame', 1))
    if fault == 'dtype':
        states = states[:4] + (states[4].long(),) + states[5:]
    if fault == 'shape':
        embs = embs[..., :-1]
    if fault == 'detections':
        dets = (torch.zeros((1, 300, 4)),) + dets[1:]
    app = (torch.zeros(1, 32, 31), torch.zeros(1, 16, 32)) \
        if fault == 'appearance' else None
    with pytest.raises(ValueError, match='assoc_costs'):
        acost.assoc_costs_launch_args(*params('frame'), states, hists, dets,
                                      embs, appearance=app)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', list(CASES))
def test_kernel_matches_plain_version(cuda, kind):
    case = costs_case(kind, CASE_SEEDS[kind])
    on_card = torch_case(case, cuda)
    before = acost.assoc_costs.launches
    # the split path's distances as the CPU computes them, which the
    # sha256 of the host build read
    app = given_appearance(kind, torch_case(case))
    app = None if app is None else tuple(a.to(cuda) for a in app)
    got = acost.assoc_costs(*params(kind), *on_card, ALL_CASES[kind].emb_cap,
                            app)
    torch.cuda.synchronize()
    assert acost.assoc_costs.launches == before + 1
    euclidean = ALL_CASES[kind].metric == 'euclidean'
    assert_costs_close(got, plain(kind, on_card, app), f'{kind} on the card',
                       plain_appearance(kind, on_card, app),
                       euclidean=euclidean)
    cpu = torch_case(case)
    assert_costs_close(got, plain(kind, cpu), f'{kind} CPU',
                       plain_appearance(kind, cpu), euclidean=euclidean)
    assert output_sha256(got) == OUTPUT_SHA256[kind]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', list(EDGE_CASES))
def test_kernel_at_the_edges(cuda, kind):
    """The card's build on the edge cases, against the plain version on the
    CPU and the first design's outputs."""
    cpu = torch_case(costs_case(kind, CASE_SEEDS[kind]))
    app = given_appearance(kind, cpu)
    got = acost.assoc_costs(*params(kind), *torch_case(
        costs_case(kind, CASE_SEEDS[kind]), cuda), EDGE_CASES[kind].emb_cap,
        None if app is None else tuple(a.to(cuda) for a in app))
    torch.cuda.synchronize()
    assert_costs_close(got, plain(kind, cpu), f'{kind} CPU',
                       plain_appearance(kind, cpu),
                       euclidean=EDGE_CASES[kind].metric == 'euclidean')
    assert output_sha256(got) == EDGE_SHA256[kind]


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(cuda):
    states, hists, dets, embs = torch_case(costs_case('streams', 2), cuda)
    ttr.assoc_costs_batch(params('streams'), states, hists, dets, embs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        ttr.assoc_costs_batch(params('streams'), states, hists, dets, embs)
        ttr.assoc_costs_core(*params('streams'), tuple(a[0] for a in states),
                             tuple(a[0] for a in hists),
                             *(a[0] for a in dets), embs[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
