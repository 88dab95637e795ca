"""The association solvers' kernels of the port (``csrc/assoc_solvers.cu``,
wrappers ``ops.assignment.cascade_auction``, ``auction_lap``,
``greedy_match`` and ``greedy_match_arrays``): the whole auction cascade of
a frame in one launch, and the finals' greedy matchings in another.

On the CPU the kernels' own source is built for the host with g++ through
tests/cuda_host_shim.py (a launch's blocks in turn on a team of host
threads, the warp collectives meetings of a warp's 32, the 64-bit
``atomicMax`` the compiler's builtin, ``-ffp-contract=off`` as the card's
build runs under ``-fmad=false``; the kernels stride their loops by the
block's thread count and take whole warps, so the tests run them with 32
or 64 threads a block). Each build equals the plain versions
(``auction_lap_reference``, ``cascade_reference``,
``greedy_match_reference``) bit for bit, every output, on seeded cases:
near-tie costs (the ``stage1_cost`` recipe of scripts/prof_auction.py at a
small size), exact ties, all forbidden, one allowed entry a row, empty
stages, more rows than columns and more columns than rows, two streams of
which one converges first, and the round cap of ``max_iters``; on the
tracker's own association arguments (``StreamTracker`` and ``MultiTracker``
on the CPU, every solver call checked); and the plain versions and the
host build equal the JAX package's ``_stages_scan_core`` and
``_finals_core`` integer outputs exactly on the same inputs.

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the CPU test that needs it):

    python -m pytest tests/test_torch_assoc_solvers.py -m cuda
"""
import ctypes

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.ops import assignment as asg
from fastmot_tpu_torch.ops import distance as tdist

from .cuda_host_shim import build_host

F32 = np.float32
INF = asg.INF_COST
N_DEPTH = 4
CONFIRM = 3
AUCTION_KINDS = ('near_tie', 'ties', 'forbidden', 'one_live', 'tall',
                 'wide', 'two_streams', 'cap')
GREEDY_KINDS = ('ties', 'gated', 'tall', 'wide', 'two_streams')


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_ssd.py's fixture of the
    name (that file imports JAX, which the card's tests here must not):
    the tier-1 run puts six workers on the cores, and the plain solvers'
    many small ops run far slower on an oversubscribed thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage1_cost(rng, t_live=24, d_live=16, cap=32, field=(480, 270)):
    """scripts/prof_auction.py's stage-1 cost at a small size: near-tie
    appearance (0.35 + N(0, 2e-3)) fused with a Mahalanobis-like distance
    of tracks placed near the detections, gated to INF. The field shrinks
    with the detections (the script's 40 on 1280x720), so that about as
    many tracks contend for a detection."""
    dx, dy = rng.uniform(0, field[0], d_live), rng.uniform(0, field[1], d_live)
    tx = np.concatenate([dx + rng.normal(0, 12, d_live),
                         rng.uniform(0, field[0], t_live - d_live)])
    ty = np.concatenate([dy + rng.normal(0, 12, d_live),
                         rng.uniform(0, field[1], t_live - d_live)])
    d2 = ((tx[:, None] - dx[None]) ** 2
          + (ty[:, None] - dy[None]) ** 2) / 40.0 ** 2
    maha = np.clip(d2, 0, 12.0) / 9.4877
    app = 0.35 + rng.normal(0, 2e-3, (t_live, d_live))
    fused = 0.8 * app + 0.2 * maha
    gated = np.where((maha > 1.0) | (fused > 0.9), INF, fused)
    cost = np.full((cap, cap), INF, F32)
    cost[:t_live, :d_live] = gated
    rv, cv = np.arange(cap) < t_live, np.arange(cap) < d_live
    return cost, rv, cv


def auction_case(kind, seed=0):
    """(cost [S, r, c], row_valid, col_valid, max_iters) of a kind of
    case."""
    rng = np.random.default_rng(seed)
    max_iters = 10000
    if kind == 'near_tie':
        cost, rv, cv = stage1_cost(rng)
        cost, rv, cv = cost[None], rv[None], cv[None]
    elif kind == 'ties':           # exact ties in values and in bids
        cost = np.round(rng.uniform(0, 1, (1, 20, 20)) * 4) / 4
        cost[0, :, 7] = 0.25
    elif kind == 'forbidden':
        cost = np.full((1, 16, 16), INF)
    elif kind == 'one_live':       # one allowed entry a row (gated motion)
        cost = np.full((1, 24, 24), INF)
        cost[0, np.arange(24), (np.arange(24) * 7) % 24] = \
            rng.uniform(0, 1, 24)
    elif kind == 'tall':
        cost = rng.uniform(0, 1, (1, 40, 24))
        cost[rng.uniform(size=cost.shape) < 0.3] = INF
    elif kind == 'wide':
        cost = rng.uniform(0, 1, (1, 24, 40))
        cost[rng.uniform(size=cost.shape) < 0.3] = INF
    elif kind in ('two_streams', 'cap'):
        # a contested dense stream and a near-diagonal one that settles in
        # one round; the cap cuts the contested one short
        cost = rng.uniform(0, 1, (2, 24, 20))
        cost[1] = INF
        cost[1, np.arange(20), (np.arange(20) * 7) % 20] = \
            rng.uniform(0, 1, 20)
        max_iters = 8 if kind == 'cap' else max_iters
    else:
        raise ValueError(kind)
    if kind not in ('near_tie',):
        rv = np.ones(cost.shape[:2], bool)
        cv = np.ones((cost.shape[0], cost.shape[2]), bool)
        if kind == 'tall':
            rv[0, ::5] = False
            cv[0, 3::7] = False
    return cost.astype(F32), rv, cv, max_iters


def cascade_case(kind, seed=0):
    """The cascade's arguments (costs, masks, cost_of, exclude, u_det,
    col4row, max_iters) as numpy, [S, ...]: the tracker's six stages over
    tracks of ages 0-7 and hits 0-5; 'empty' leaves two depth stages and
    the unconfirmed stage without rows, 'two_streams' stacks a near-tie
    frame and a sparse one, 'cap' caps the rounds at 8."""
    rng = np.random.default_rng(seed)
    n_streams = 2 if kind in ('two_streams', 'cap') else 1
    t_cap, d_cap = (40, 24) if kind == 'tall' else (32, 32)
    costs, ious, masks = [], [], []
    for s in range(n_streams):
        cost, _, _ = stage1_cost(rng, t_live=min(24, t_cap),
                                 d_live=min(16, d_cap), cap=max(t_cap, d_cap))
        cost = cost[:t_cap, :d_cap]
        if s == 1:
            cost = np.where(rng.uniform(size=cost.shape) < 0.1,
                            rng.uniform(0, 0.9, cost.shape), INF)
        iou = rng.uniform(0, 1, (t_cap, d_cap))
        iou[iou > 0.6] = INF
        ages = rng.integers(0, 8, t_cap)
        hits = rng.integers(0, 6, t_cap)
        valid = np.arange(t_cap) < 28
        if kind == 'empty':
            ages = np.where(ages // 2 >= 2, 1, ages)
            hits = np.maximum(hits, CONFIRM)
        confirmed = hits >= CONFIRM
        masks.append([valid & confirmed & (ages // 2 == d)
                      for d in range(N_DEPTH)]
                     + [valid & confirmed & (ages < 2), valid & ~confirmed])
        costs.append(cost)
        ious.append(iou)
    masks = [np.stack([m[k] for m in masks]) for k in range(N_DEPTH + 2)]
    u_det = rng.uniform(size=(n_streams, d_cap)) < 0.9
    col4row = np.full((n_streams, t_cap), -1, np.int32)
    return ((np.stack(costs).astype(F32), np.stack(ious).astype(F32)),
            masks, (0,) * N_DEPTH + (1, 1), (False,) * N_DEPTH + (True, False),
            u_det, col4row, 8 if kind == 'cap' else 10000)


CASCADE_KINDS = ('frame', 'empty', 'tall', 'two_streams', 'cap')


def greedy_case(kind, seed=0):
    """Two greedy problems ((cost, row_valid, col_valid, max_cost), ...) of
    one stream count, as finals_core hands them (the reID and the rectify
    problem)."""
    rng = np.random.default_rng(seed)
    n_streams = 2 if kind == 'two_streams' else 1
    shapes = {'tall': ((40, 24), (24, 24)), 'wide': ((16, 40), (32, 32))}
    out = []
    for k, (r, c) in enumerate(shapes.get(kind, ((16, 32), (32, 32)))):
        cost = rng.uniform(0, 1, (n_streams, r, c))
        if kind == 'ties':
            cost = np.round(cost * 4) / 4
        if kind == 'gated':          # few entries under the gates
            cost += 0.3
        cost[rng.uniform(size=cost.shape) < 0.2] = INF
        rv = rng.uniform(size=(n_streams, r)) < 0.8
        cv = rng.uniform(size=(n_streams, c)) < 0.8
        out.append((cost.astype(F32), rv, cv, (0.45, 0.2)[k]))
    return out


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    lib = build_host('assoc_solvers', tmp_path_factory, launches=2)
    for entry in (lib.cascade_auction_forward, lib.greedy_match_forward):
        entry.argtypes = asg.FORWARD_ARGTYPES
        entry.restype = ctypes.c_int
    return lib


def host_auction(lib, cost, rv, cv, max_iters=10000, threads=32):
    """``auction_lap`` through the host build: (row4col, col4row,
    rounds, bids)."""
    lib.set_host_threads(threads)
    (_, c4r, r4c, rounds, bids), args, keep = asg.cascade_launch_args(
        (cost,), (rv,), (0,), (False,), cv, None, 1e-2, max_iters,
        row4col=True, rounds=True)
    assert lib.cascade_auction_forward(*args) == 0
    return r4c, c4r, rounds, bids


def host_cascade(lib, costs, masks, cost_of, exclude, u_det, col4row,
                 eps_final=1e-2, max_iters=10000, forbid=asg.FORBID,
                 threads=32):
    """``cascade_auction`` through the host build, [S, ...] or one stream:
    (u_det, col4row, rounds, bids)."""
    lib.set_host_threads(threads)
    one = costs[0].dim() == 2
    if one:
        costs = tuple(c[None] for c in costs)
        masks = tuple(m[None] for m in masks)
        u_det, col4row = u_det[None], col4row[None]
    (u, c4r, _, rounds, bids), args, keep = asg.cascade_launch_args(
        costs, masks, cost_of, exclude, u_det, col4row, eps_final,
        max_iters, forbid, rounds=True)
    assert lib.cascade_auction_forward(*args) == 0
    return (u[0], c4r[0], rounds[0], bids[0]) if one else (u, c4r, rounds,
                                                           bids)


def host_greedy(lib, problems, threads=32):
    """``greedy_match`` through the host build, [S, ...] or one stream."""
    lib.set_host_threads(threads)
    one = problems[0][0].dim() == 2
    if one:
        problems = [(c[None], r[None], v[None], m)
                    for c, r, v, m in problems]
    outputs, args, keep = asg.greedy_launch_args(problems)
    assert lib.greedy_match_forward(*args) == 0
    return [(a[0], b[0]) for a, b in outputs] if one else outputs


def torch_cascade(case):
    costs, masks, cost_of, exclude, u_det, col4row, max_iters = case
    return (tuple(T(c) for c in costs), tuple(T(m) for m in masks), cost_of,
            exclude, T(u_det), T(col4row)), max_iters


def test_cases_are_what_they_say(host_kernel):
    """Each kind exercises its path: near ties and exact ties among the
    values, a stage of nothing allowed, two streams that settle after
    different numbers of rounds, a cap that cuts the contested stream
    short, stages with no row."""
    cost, rv, cv, _ = auction_case('near_tie')
    live = np.sort(cost[0][rv[0]][:, cv[0]], 0)      # a column's rows
    near = (live[1] < INF) & (live[1] - live[0] < 0.02)
    assert (live < INF).sum() > 40 and near.sum() >= 3, near
    cost = auction_case('ties')[0][0]
    assert len(np.unique(cost)) <= 5
    _, _, rounds, _ = host_auction(host_kernel, *map(T, auction_case(
        'two_streams')[:3]))
    assert rounds[0].sum() > 3 * rounds[1].sum() > 0, rounds
    cost, rv, cv, cap = auction_case('cap')
    capped = host_auction(host_kernel, T(cost), T(rv), T(cv), cap)
    full = asg.auction_lap_reference(T(cost), T(rv), T(cv), 1e-2)
    assert (capped[2][0] == 8).any() and not torch.equal(capped[1][0],
                                                         full[1][0])
    assert torch.equal(capped[1][1], full[1][1])
    _, masks, *_ = cascade_case('empty')
    assert sum(not m.any() for m in masks) == 3


@pytest.mark.parametrize('kind', AUCTION_KINDS)
def test_host_auction_equals_plain_version(host_kernel, kind):
    cost, rv, cv, max_iters = (T(a) if isinstance(a, np.ndarray) else a
                               for a in auction_case(kind, seed=1))
    r4c, c4r, rounds, bids = host_auction(host_kernel, cost, rv, cv,
                                          max_iters)
    want = asg.auction_lap_reference(cost, rv, cv, 1e-2, max_iters)
    assert torch.equal(r4c, want[0]) and torch.equal(c4r, want[1])
    assert (rounds <= asg.round_cap(max_iters)).all()
    # a round has a bid at least and a bid a row at most
    n = max(cost.shape[1:])
    assert (rounds <= bids).all() and (bids <= n * rounds).all()


def test_host_auction_counts_its_bids(host_kernel):
    """One allowed entry a row, on a permutation of the columns: every row
    bids once in the first round of the first phase, which settles it; the
    second phase keeps every owner and bids no more."""
    cost, rv, cv, _ = map(T, auction_case('one_live'))
    _, c4r, rounds, bids = host_auction(host_kernel, cost, rv, cv)
    assert (c4r[0] >= 0).all()
    assert rounds.tolist() == [[[1, 0]]] and bids.tolist() == [[[24, 0]]]


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in CASCADE_KINDS]
                         + [('empty', 64), ('two_streams', 64)])
def test_host_cascade_equals_plain_version(host_kernel, kind, threads):
    args, max_iters = torch_cascade(cascade_case(kind, seed=2))
    u, c4r, rounds, bids = host_cascade(host_kernel, *args,
                                        max_iters=max_iters, threads=threads)
    want = asg.cascade_reference(*args, max_iters=max_iters)
    assert torch.equal(u, want[0]) and torch.equal(c4r, want[1])
    assert rounds.shape == bids.shape == (args[0][0].shape[0], N_DEPTH + 2,
                                          2)
    n = max(args[0][0].shape[1:])
    assert (rounds <= bids).all() and (bids <= n * rounds).all()
    assert (c4r >= 0).sum() > 4


def test_host_cascade_streams_are_independent(host_kernel):
    """A stream of a batch gets what it gets alone."""
    args, _ = torch_cascade(cascade_case('two_streams', seed=3))
    u, c4r, *_ = host_cascade(host_kernel, *args)
    for s in range(2):
        one = host_cascade(host_kernel, tuple(c[s] for c in args[0]),
                           tuple(m[s] for m in args[1]), *args[2:4],
                           args[4][s], args[5][s])
        assert torch.equal(one[0], u[s]) and torch.equal(one[1], c4r[s])


@pytest.mark.parametrize('kind', GREEDY_KINDS)
def test_host_greedy_equals_plain_version(host_kernel, kind):
    problems = [(T(c), T(r), T(v), m) for c, r, v, m in greedy_case(kind, 4)]
    got = host_greedy(host_kernel, problems, 64 if kind == 'tall' else 32)
    for (r4c, c4r), p in zip(got, problems):
        want = asg.greedy_match_reference(*p)
        assert torch.equal(r4c, want[0]) and torch.equal(c4r, want[1])
    assert sum(int((c4r >= 0).sum()) for _, c4r in got) > 2


def frame_inputs(seed, t_cap=32, d_cap=32, h_cap=16):
    """One stream's association inputs, as numpy: the cascade's (costs from
    stage1_cost and the boxes' IoU distance) and the finals' (boxes, ages,
    hits, confidences, a reID cost with ties). Track 0 (active, confirmed,
    no allowed entry) sits on the detection that track 16 (inactive,
    confirmed) alone may take, a duplicate for the rectify match."""
    rng = np.random.default_rng(seed)
    cost, _, _ = stage1_cost(rng, t_live=24, d_live=20, cap=32)
    xy = rng.uniform(0, 280, (d_cap, 2))
    d_tlbrs = np.concatenate([xy, xy + rng.uniform(20, 60, (d_cap, 2))], 1)
    order = rng.permutation(d_cap)[:t_cap]
    tlbrs = d_tlbrs[order] + rng.normal(0, 3, (t_cap, 4))
    tlbrs[t_cap // 2:] = tlbrs[:t_cap - t_cap // 2] + rng.normal(0, 2, 4)
    tlbrs[0] = d_tlbrs[order[0]] + 0.5
    ages = rng.integers(0, 8, t_cap).astype(np.int32)
    hits = rng.integers(0, 6, t_cap).astype(np.int32)
    ages[0], ages[16], hits[0], hits[16] = 0, 4, 5, 5
    cost[[0, 16]] = INF
    cost[:, order[0]] = INF
    cost[16, order[0]] = 0.3
    labels = np.zeros(t_cap, np.int32)
    iou = asg.gate_cost(tdist.iou_dist(T(tlbrs.astype(F32)),
                                       T(d_tlbrs.astype(F32))),
                        T(labels), T(np.zeros(d_cap, np.int32)),
                        0.6).numpy()
    iou[0] = INF
    valid = np.arange(t_cap) < 28
    confirmed = hits >= CONFIRM
    reid = np.round(rng.uniform(0, 1, (h_cap, d_cap)) * 8) / 8
    reid[rng.uniform(size=reid.shape) < 0.3] = INF
    return dict(
        cost=cost, iou_cost=iou.astype(F32),
        depth_masks=[valid & confirmed & (ages // 2 == d)
                     for d in range(N_DEPTH)],
        base_iou_active=valid & confirmed & (ages < 2),
        base_unconfirmed=valid & ~confirmed,
        u_det=np.arange(d_cap) < 26, col4row=np.full(t_cap, -1, np.int32),
        tlbrs=tlbrs.astype(F32), t_valid=valid, ages=ages, hits=hits,
        d_tlbrs=d_tlbrs.astype(F32),
        d_conf=rng.uniform(0.3, 1.0, d_cap).astype(F32),
        reid_cost=reid.astype(F32), h_reid_ok=rng.uniform(size=h_cap) < 0.8,
        occluded=rng.uniform(size=d_cap) < 0.2)


def port_frame(f):
    """``stages_scan_core`` then ``finals_core`` on the port's tensors:
    (u_det, col4row, u_det_conf, reid_c4r, rect_c4r)."""
    t = {k: ([T(m) for m in v] if isinstance(v, list) else T(v))
         for k, v in f.items()}
    u_det, col4row = ttr.stages_scan_core(
        N_DEPTH, t['cost'], t['iou_cost'], t['depth_masks'],
        t['base_iou_active'], t['base_unconfirmed'], t['u_det'],
        t['col4row'])
    return (u_det, col4row) + ttr.finals_core(
        0.5, 0.45, 0.2, CONFIRM, t['tlbrs'], t['t_valid'], t['ages'],
        t['hits'], t['d_tlbrs'], t['d_conf'], t['reid_cost'],
        t['h_reid_ok'], t['occluded'], u_det, col4row)


def routed_to(monkeypatch, lib, threads=32):
    """``asg.cascade_auction`` and ``asg.greedy_match`` through the host
    build."""
    def cascade(costs, masks, cost_of, exclude, u_det, col4row,
                eps_final=1e-2, max_iters=10000, forbid=asg.FORBID):
        return host_cascade(lib, costs, masks, cost_of, exclude, u_det,
                            col4row, eps_final, max_iters, forbid,
                            threads)[:2]
    monkeypatch.setattr(asg, 'cascade_auction', cascade)
    monkeypatch.setattr(asg, 'greedy_match',
                        lambda problems: host_greedy(lib, problems, threads))


def test_plain_and_host_match_jax(host_kernel, monkeypatch):
    """The whole cascade and the finals, plain and host build, against the
    JAX package's ``_stages_scan_core`` and ``_finals_core``: every integer
    output equal."""
    import jax.numpy as jnp
    from fastmot_tpu import tracker as jtr
    for seed in (5, 6):
        f = frame_inputs(seed)
        j = {k: ([jnp.asarray(m) for m in v] if isinstance(v, list)
                 else jnp.asarray(v)) for k, v in f.items()}
        u_det, col4row = jtr._stages_scan_kernel(
            N_DEPTH, j['cost'], j['iou_cost'], tuple(j['depth_masks']),
            j['base_iou_active'], j['base_unconfirmed'], j['u_det'],
            j['col4row'], eps=1e-2)
        want = (u_det, col4row) + tuple(jtr._finals_kernel(
            0.5, 0.45, 0.2, CONFIRM, j['tlbrs'], j['t_valid'], j['ages'],
            j['hits'], j['d_tlbrs'], j['d_conf'], j['reid_cost'],
            j['h_reid_ok'], j['occluded'], u_det, col4row))
        plain = port_frame(f)
        with monkeypatch.context() as m:
            routed_to(m, host_kernel)
            host = port_frame(f)
        assert int((plain[1] >= 0).sum()) > 8
        assert int((plain[4] >= 0).sum()) > 0 and \
            int((plain[3] >= 0).sum()) > 0
        for p, h, w in zip(plain, host, want):
            np.testing.assert_array_equal(p.numpy(), np.asarray(w))
            np.testing.assert_array_equal(h.numpy(), np.asarray(w))


def test_tracker_arguments_host_build_equals_plain(host_kernel, monkeypatch):
    """``StreamTracker`` (2 streams) and ``MultiTracker`` association frames
    on the CPU: every plain solver call's arguments pass the kernels'
    checks and the host build gives the same outputs; one cascade and one
    greedy call (of two problems) a frame for all of a call's streams."""
    from fastmot_tpu_torch.detector import MAX_DETS
    from fastmot_tpu_torch.parallel import StreamTracker
    calls = []
    cascade, greedy = asg.cascade_reference, asg.greedy_match_reference

    def checked_cascade(*args):
        got = host_cascade(host_kernel, *args)[:2]
        want = cascade(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        calls.append(('cascade', tuple(args[0][0].shape[:-2])))
        return want

    def checked_greedy(problems):
        got = host_greedy(host_kernel, problems)
        want = [greedy(*p) for p in problems]
        assert all(torch.equal(a, b) for g, w in zip(got, want)
                   for a, b in zip(g, w))
        calls.append(('greedy', len(problems)))
        return want
    monkeypatch.setattr(asg, 'cascade_reference', checked_cascade)
    monkeypatch.setattr(asg, 'greedy_match', lambda problems:
                        checked_greedy(problems))
    size, n_obj = (160, 120), 4
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (2, size[1], size[0], 3), np.uint8)
    st = StreamTracker(size, 'euclidean', 2, device='cpu', max_age=6)
    st.reset(1 / 30.0)
    emb = rng.normal(size=(2, MAX_DETS, 512)).astype(F32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    for f in (1, 2, 3):
        tlbr = np.zeros((2, MAX_DETS, 4), F32)
        x = 10.0 + 35 * np.arange(n_obj) + f
        tlbr[:, :n_obj] = np.stack([x, x * 0 + 20, x + 25, x * 0 + 90], -1)
        valid = np.arange(MAX_DETS)[None].repeat(2, 0) < n_obj
        st.update_device(f, (T(tlbr), T(np.where(valid, 1, -1).astype(
            np.int32)), T(np.where(valid, 0.9, 0).astype(F32)), T(valid)),
            T(emb))
        st.sync()
    assert calls == [('cascade', (2,)), ('greedy', 2)] * 3
    assert sum(len(t.tracks) for t in st.trackers) == 2 * n_obj
    calls.clear()
    trk = ttr.MultiTracker(size, 'euclidean', device='cpu')
    trk.reset(1 / 30.0)
    from fastmot_tpu_torch.detector import make_detections
    boxes = tlbr[0, :n_obj].astype(float)
    trk.init(torch.from_numpy(frame[0]), make_detections(
        boxes, np.ones(n_obj, int), np.full(n_obj, 0.9)))
    trk.update(1, make_detections(boxes + 1, np.ones(n_obj, int),
                                  np.full(n_obj, 0.9)), emb[0, :n_obj])
    assert calls == [('cascade', ()), ('greedy', 2)]


# ---------------------------------------------------------------------------
# The wrappers and their checks
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_are_the_plain_versions():
    cost, rv, cv, _ = (T(a) if isinstance(a, np.ndarray) else a
                       for a in auction_case('tall', seed=8))
    for got, want in ((asg.auction_lap(cost, rv, cv, 1e-2),
                       asg.auction_lap_reference(cost, rv, cv, 1e-2)),
                      (asg.cascade_auction(*torch_cascade(
                          cascade_case('frame', 8))[0]),
                       asg.cascade_reference(*torch_cascade(
                           cascade_case('frame', 8))[0]))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    problems = [(T(c), T(r), T(v), m) for c, r, v, m in greedy_case('ties')]
    for got, p in zip(asg.greedy_match(problems), problems):
        assert all(torch.equal(g, w) for g, w in
                   zip(got, asg.greedy_match_reference(*p)))
    got = asg.greedy_match_arrays(*problems[0])
    assert all(torch.equal(g, w) for g, w in
               zip(got, asg.greedy_match_reference(*problems[0])))


def test_wrappers_raise_on_other_devices():
    meta = torch.zeros((1, 8, 8), device='meta')
    mask = torch.ones((1, 8), dtype=torch.bool, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        asg.auction_lap(meta)
    with pytest.raises(ValueError, match='unsupported device'):
        asg.cascade_auction((meta,), (mask,), (0,), (False,), mask,
                            torch.zeros((1, 8), dtype=torch.int32,
                                        device='meta'))
    with pytest.raises(ValueError, match='unsupported device'):
        asg.greedy_match([(meta, mask, mask, 0.5)])
    with pytest.raises(ValueError, match='unsupported device'):
        asg.greedy_match_arrays(meta, mask, mask, 0.5)


def _faulty_cascade(fault):
    (costs, masks, cost_of, exclude, u_det, col4row), _ = torch_cascade(
        cascade_case('frame'))
    if fault == 'dtype':
        costs = (costs[0].double(), costs[1])
    elif fault == 'mask':
        masks = masks[:-1] + (masks[-1][:, :-1],)
    elif fault == 'col4row':
        col4row = col4row.long()
    elif fault == 'size':
        big = torch.zeros((1, 130, 130))
        costs = (big, big)
        masks = tuple(torch.ones((1, 130), dtype=torch.bool) for _ in masks)
        u_det = torch.ones((1, 130), dtype=torch.bool)
        col4row = torch.full((1, 130), -1, dtype=torch.int32)
    elif fault == 'stages':
        masks, cost_of, exclude = masks * 11, cost_of * 11, exclude * 11
    elif fault == 'cost_of':
        cost_of = (2,) + cost_of[1:]
    eps = 0.0 if fault == 'eps' else 1e-2
    return costs, masks, cost_of, exclude, u_det, col4row, eps


@pytest.mark.parametrize('fault', ['dtype', 'mask', 'col4row', 'size',
                                   'stages', 'cost_of', 'eps'])
def test_cascade_launch_args_raise_on_each_fault(fault):
    asg.cascade_launch_args(*_faulty_cascade(None))  # the unbroken call
    with pytest.raises(ValueError, match='assoc_solvers: '):
        asg.cascade_launch_args(*_faulty_cascade(fault))


@pytest.mark.parametrize('fault', ['dtype', 'streams', 'size', 'problems'])
def test_greedy_launch_args_raise_on_each_fault(fault):
    problems = [(T(c), T(r), T(v), m) for c, r, v, m in greedy_case('ties')]
    asg.greedy_launch_args(problems)
    if fault == 'dtype':
        problems[0] = (problems[0][0], problems[0][1].int()) + problems[0][2:]
    elif fault == 'streams':
        problems[1] = (problems[1][0].expand(2, -1, -1),) + problems[1][1:]
    elif fault == 'size':
        problems[0] = (torch.zeros((1, 5000, 2)),
                       torch.ones((1, 5000), dtype=torch.bool),
                       torch.ones((1, 2), dtype=torch.bool), 0.5)
    elif fault == 'problems':
        problems = problems * 3
    with pytest.raises(ValueError, match='assoc_solvers: '):
        asg.greedy_launch_args(problems)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', AUCTION_KINDS)
def test_kernel_auction_matches_plain_version(cuda, kind):
    cost, rv, cv, max_iters = (T(a) if isinstance(a, np.ndarray) else a
                               for a in auction_case(kind, seed=1))
    before = asg.cascade_auction.launches
    got = asg.auction_lap(cost.to(cuda), rv.to(cuda), cv.to(cuda), 1e-2,
                          max_iters)
    torch.cuda.synchronize()
    assert asg.cascade_auction.launches == before + 1
    want = asg.auction_lap_reference(cost, rv, cv, 1e-2, max_iters)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', CASCADE_KINDS)
def test_kernel_cascade_matches_plain_version(cuda, kind):
    args, max_iters = torch_cascade(cascade_case(kind, seed=2))
    dev = (tuple(c.to(cuda) for c in args[0]),
           tuple(m.to(cuda) for m in args[1]), *args[2:4],
           args[4].to(cuda), args[5].to(cuda))
    got = asg.cascade_auction(*dev, max_iters=max_iters)
    want = asg.cascade_reference(*args, max_iters=max_iters)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', GREEDY_KINDS)
def test_kernel_greedy_matches_plain_version(cuda, kind):
    problems = [(T(c), T(r), T(v), m) for c, r, v, m in greedy_case(kind, 4)]
    before = asg.greedy_match.launches
    got = asg.greedy_match([(c.to(cuda), r.to(cuda), v.to(cuda), m)
                            for c, r, v, m in problems])
    torch.cuda.synchronize()
    assert asg.greedy_match.launches == before + 1
    for g, p in zip(got, problems):
        assert all(torch.equal(a.cpu(), b) for a, b in
                   zip(g, asg.greedy_match_reference(*p)))


@pytest.mark.cuda
def test_kernels_run_without_a_host_sync(cuda):
    """``stages_scan_core`` and ``finals_core`` on the card under
    ``torch.cuda.set_sync_debug_mode('error')``, equal to the CPU run."""
    f = frame_inputs(5)
    want = port_frame(f)
    t = {k: ([T(m).to(cuda) for m in v] if isinstance(v, list)
             else T(v).to(cuda)) for k, v in f.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        u_det, col4row = ttr.stages_scan_core(
            N_DEPTH, t['cost'], t['iou_cost'], t['depth_masks'],
            t['base_iou_active'], t['base_unconfirmed'], t['u_det'],
            t['col4row'])
        got = (u_det, col4row) + ttr.finals_core(
            0.5, 0.45, 0.2, CONFIRM, t['tlbrs'], t['t_valid'], t['ages'],
            t['hits'], t['d_tlbrs'], t['d_conf'], t['reid_cost'],
            t['h_reid_ok'], t['occluded'], u_det, col4row)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
