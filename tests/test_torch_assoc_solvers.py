"""The association solvers' kernels of the port (``csrc/assoc_solvers.cu``,
wrappers ``ops.assignment.cascade_auction``, ``auction_lap``,
``greedy_match``, ``greedy_match_arrays`` and ``greedy_finals``): the whole
auction cascade of a frame in one launch, and the finals (their masks, the
rectify cost and both greedy matchings) in another.

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
which one converges first, and the round cap of ``max_iters``; more live
rows than live columns, rows priced out onto dead columns whose dead rows
they displace, sizes whose rows are not 16-byte multiples, ``exclude``
stages after matches, the contested stage-1 costs at the kernel's full
width, greedy problems of tens of matches, and the finals with the
rectify cost computed in the kernel (``finals_reference`` the plain
version); on the tracker's own association arguments (``StreamTracker``
and ``MultiTracker`` on the CPU, every solver call checked); and the plain
versions and the host build equal the JAX package's ``_stages_scan_core``
and ``_finals_core`` integer outputs exactly on the same inputs. Every
output of every seeded case (the rounds and bids by stage and phase too)
is, to the bit, what the first design of the kernels gave
(``OUTPUT_SHA256``), at several team sizes (a lone bidder's rounds on
warp 0 while one to four other warps wait).

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the CPU test that needs it):

    python -m pytest tests/test_torch_assoc_solvers.py -m cuda
"""
import ctypes
import hashlib

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
                 'wide', 'two_streams', 'cap', 'crowded', 'displaced', 'odd',
                 'stage1')
GREEDY_KINDS = ('ties', 'gated', 'tall', 'wide', 'two_streams', 'contested',
                'big')
# the 'displaced' auction: rows DISPLACED_ROWS have one allowed entry, in
# column 0; row 3 has three, in columns 1-3 (1 the cheapest); every other
# row and column of the 32 x 32 square is dead
DISPLACED_ROWS = (5, 9, 13)


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
    many tracks contend for a detection; ``stage1_full`` is the full
    width."""
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


def stage1_full(seed):
    """chip_smoke.py's ``stage1_cost`` (the contested regime at the kernel's
    full width: 64 tracks and 40 detections on 1280 x 720, padded to 128),
    drawn in the same order from the same seed: (cost, iou, row_valid,
    col_valid, the six stages' row masks)."""
    rng = np.random.default_rng(seed)
    cost, rv, cv = stage1_cost(rng, 64, 40, 128, (1280, 720))
    # the IoU-like cost of the same tracks and detections, as chip_smoke.py
    # builds it, and the masks of tracks of ages 0-7 and hits 0-5
    rng = np.random.default_rng(seed)
    dx, dy = rng.uniform(0, 1280, 40), rng.uniform(0, 720, 40)
    tx = np.concatenate([dx + rng.normal(0, 12, 40),
                         rng.uniform(0, 1280, 24)])
    ty = np.concatenate([dy + rng.normal(0, 12, 40),
                         rng.uniform(0, 720, 24)])
    rng.normal(0, 2e-3, (64, 40))
    d2 = ((tx[:, None] - dx[None]) ** 2 + (ty[:, None] - dy[None]) ** 2) \
        / 40.0 ** 2
    iou = np.full((128, 128), INF, F32)
    iou[:64, :40] = np.where(np.sqrt(d2) < 1.0, np.clip(np.sqrt(d2), 0, 1),
                             INF)
    ages, hits = rng.integers(0, 8, 128), rng.integers(0, 6, 128)
    confirmed = hits >= CONFIRM
    masks = [rv & confirmed & (ages // 2 == d) for d in range(N_DEPTH)]
    masks += [rv & confirmed & (ages < 2), rv & ~confirmed]
    return cost, iou, rv, cv, masks


def auction_case(kind, seed=0):
    """(cost [S, r, c], row_valid, col_valid, max_iters) of a kind of
    case: 'crowded' has more live rows than live columns (priced-out rows
    take dead columns), 'displaced' rows priced out of their one column
    while every dead column is owned by a pre-assigned dead row (see
    test_cases_are_what_they_say), 'odd' a size whose rows are not 16-byte
    multiples, 'stage1' the contested stage-1 cost at full width."""
    rng = np.random.default_rng(seed)
    max_iters = 10000
    if kind == 'stage1':
        cost, _, rv, cv, _ = stage1_full(seed)
        return cost[None], rv[None], cv[None], max_iters
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
    elif kind == 'crowded':
        cost = rng.uniform(0, 1, (1, 32, 32))
        cost[rng.uniform(size=cost.shape) < 0.2] = INF
    elif kind == 'displaced':
        cost = np.full((1, 32, 32), INF)
        cost[0, DISPLACED_ROWS, 0] = (0.5, 0.4, 0.45)
        cost[0, 3, 1:4] = (0.1, 0.6, 0.7)
    elif kind == 'odd':
        cost = rng.uniform(0, 1, (1, 23, 19))
        cost[rng.uniform(size=cost.shape) < 0.25] = INF
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
        if kind == 'crowded':
            rv[0, 24:] = False
            cv[0, 6:] = False
    return cost.astype(F32), rv, cv, max_iters


def cascade_case(kind, seed=0):
    """The cascade's arguments (costs, masks, cost_of, exclude, u_det,
    col4row, max_iters) as numpy, [S, ...]: the tracker's six stages over
    tracks of ages 0-7 and hits 0-5; 'empty' leaves two depth stages and
    the unconfirmed stage without rows, 'two_streams' stacks a near-tie
    frame and a sparse one, 'cap' caps the rounds at 8; 'exclude' has
    every confirmed track active, so that the IoU stage's rows are the first
    stage's less its matches; 'odd' a size whose rows are not 16-byte
    multiples; 'stage1' the contested stage-1 costs at full width
    (``stage1_full``)."""
    rng = np.random.default_rng(seed)
    if kind == 'stage1':
        cost, iou, _, cv, masks = stage1_full(seed)
        return ((cost[None], iou[None]), [m[None] for m in masks],
                (0,) * N_DEPTH + (1, 1), (False,) * N_DEPTH + (True, False),
                cv[None], np.full((1, 128), -1, np.int32), 10000)
    n_streams = 2 if kind in ('two_streams', 'cap') else 1
    t_cap, d_cap = {'tall': (40, 24), 'odd': (27, 21)}.get(kind, (32, 32))
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
        if kind == 'exclude':
            ages = np.where(rng.uniform(size=t_cap) < 0.8, ages % 2, ages)
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


CASCADE_KINDS = ('frame', 'empty', 'tall', 'two_streams', 'cap', 'exclude',
                 'odd', 'stage1')


def greedy_case(kind, seed=0):
    """Two greedy problems ((cost, row_valid, col_valid, max_cost), ...) of
    one stream count, as finals_core hands them (the reID and the rectify
    problem); 'big' has a first problem of 300 rows, too many for the
    kernel's warp-wide rescans and for its shared memory."""
    rng = np.random.default_rng(seed)
    n_streams = 2 if kind == 'two_streams' else 1
    if kind == 'contested':
        return contested_greedy(rng)
    shapes = {'tall': ((40, 24), (24, 24)), 'wide': ((16, 40), (32, 32)),
              'big': ((300, 60), (24, 24))}
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


def contested_greedy(rng, shapes=((64, 128), (128, 128)), maxes=(0.45, 0.2)):
    """chip_smoke.py's ``contested_greedy`` recipe at the finals' shapes (the
    reID problem [64, 128], the rectify problem [128, 128]): the first 64
    rows and 40 columns live, costs uniform on [0, 2 max_cost) in steps of
    1/64, so with exact ties; tens of matches a problem."""
    out = []
    for (r, c), max_cost in zip(shapes, maxes):
        levels = max(2, int(128 * max_cost))
        cost = rng.integers(0, levels, (1, r, c)) / 64.0
        out.append((cost.astype(F32), (np.arange(r) < min(r, 64))[None],
                    (np.arange(c) < 40)[None], max_cost))
    return out


def finals_case(kind, seed=0):
    """``finals_core``'s arguments (conf_thresh, max_reid_cost, dup_gate,
    confirm_hits, then the tensors as numpy with a stream axis): 'frame' the
    finals of ``frame_inputs`` on the plain cascade's result; 'dups' tracks
    of which many near-duplicate pairs (an active unmatched track and an
    inactive matched one whose detection overlaps it) contend for the
    rectify matches, with reID costs of exact ties; 'two_streams' both
    stacked."""
    if kind == 'frame':
        f = frame_inputs(seed)
        t = {k: ([T(m) for m in v] if isinstance(v, list) else T(v))
             for k, v in f.items()}
        u_det, col4row = asg.cascade_reference(
            (t['cost'][None], t['iou_cost'][None]),
            tuple(m[None] for m in t['depth_masks'])
            + (t['base_iou_active'][None], t['base_unconfirmed'][None]),
            (0,) * N_DEPTH + (1, 1), (False,) * N_DEPTH + (True, False),
            t['u_det'][None], t['col4row'][None])
        tensors = [f[k][None] for k in (
            'tlbrs', 't_valid', 'ages', 'hits', 'd_tlbrs', 'd_conf',
            'reid_cost', 'h_reid_ok', 'occluded')]
        return (0.5, 0.45, 0.2, CONFIRM, *tensors, u_det.numpy(),
                col4row.numpy())
    if kind == 'two_streams':
        a, b = finals_case('frame', seed), finals_case('dups', seed)
        return a[:4] + tuple(np.concatenate([x, y]) for x, y in
                             zip(a[4:], b[4:]))
    rng = np.random.default_rng(seed)
    t_cap, d_cap, h_cap = 32, 32, 16
    xy = rng.uniform(0, 400, (d_cap, 2))
    d_tlbrs = np.concatenate([xy, xy + rng.uniform(30, 80, (d_cap, 2))], 1)
    col4row = np.full(t_cap, -1, np.int32)
    # tracks 16-31 inactive and matched to detections 0-15; tracks 0-15
    # active and unmatched, each near one of those detections, two or three
    # to a detection
    col4row[16:] = np.arange(16)
    tlbrs = np.empty((t_cap, 4))
    tlbrs[16:] = d_tlbrs[:16] + rng.normal(0, 1, (16, 4))
    near = rng.integers(0, 6, 16)
    tlbrs[:16] = d_tlbrs[near] + np.round(rng.normal(0, 2, (16, 4)))
    ages = np.where(np.arange(t_cap) < 16, rng.integers(0, 2, t_cap),
                    rng.integers(2, 8, t_cap)).astype(np.int32)
    hits = rng.integers(2, 6, t_cap).astype(np.int32)
    reid = np.round(rng.uniform(0, 1, (h_cap, d_cap)) * 8) / 8
    reid[rng.uniform(size=reid.shape) < 0.3] = INF
    tensors = (tlbrs.astype(F32), np.arange(t_cap) < 30, ages, hits,
               d_tlbrs.astype(F32), rng.uniform(0.3, 1.0, d_cap).astype(F32),
               reid.astype(F32), rng.uniform(size=h_cap) < 0.8,
               rng.uniform(size=d_cap) < 0.2, rng.uniform(size=d_cap) < 0.7,
               col4row)
    return (0.5, 0.45, 0.2, CONFIRM, *(a[None] for a in tensors))


FINALS_KINDS = ('frame', 'dups', 'two_streams')

# Every output of each seeded case as the first design of the kernels (one
# block of 1,024 threads a stream building the padded benefit each stage; a
# block a greedy problem scanning every entry each round; the finals' masks
# and rectify cost as torch ops) gave it, through the host build: (what,
# kind) -> the sha256 of the outputs' bytes in order (auction: row4col,
# col4row, rounds, bids; cascade: u_det, col4row, rounds, bids; greedy: each
# problem's row4col and col4row; finals: u_det_conf, reid_c4r, rect_c4r).
# Seeds: the auctions 1, the cascades 2, the greedy pairs 4, the finals 5.
OUTPUT_SHA256 = {
    ('auction', 'near_tie'):
        '1f8524c3679ce420c19dd202d0a51c869fa5351dbc6e571a0874e8d04486a99e',
    ('auction', 'ties'):
        '3c5e75a9faef2377d5c7e290ab73356833c388a818715e396e0d467bae363d07',
    ('auction', 'forbidden'):
        '9ea147df2427ae20ad506df53ae21e08f8546039cd12989d72d6907bda98480f',
    ('auction', 'one_live'):
        '01499b2eb970b3056895531a4400da65afa145aca18839a3289b4b6f38ecd699',
    ('auction', 'tall'):
        '4054a5147cfccacaabd13794919a85241e440265afc3a3565cc11e923b77d657',
    ('auction', 'wide'):
        '5cb341345c84de309b451f0f2c93ff7f327882085d8cae845e9367ae66951711',
    ('auction', 'two_streams'):
        'c4812cc41685bb4737cbd6140794d8e993009219e902bd6b4c6556137b0d9f26',
    ('auction', 'cap'):
        '720b405ebfff16db13d30f975f2c86701b1f1449a06f2f1780f92cb6748b8235',
    ('auction', 'crowded'):
        'f08615cea1f76bb70e860e5873fc25594392c4be70c01fc6ae92b6b3bc6a5cdb',
    ('auction', 'displaced'):
        'cdfa83f39a81e6bebc503ba25100961f479fffb14d1c30f42000230845d54f8f',
    ('auction', 'odd'):
        '3ff935092dfb892230afb88df67816ed5f436054c2dc73d69c4967439ca57574',
    ('auction', 'stage1'):
        'a44cbd90f2fa14fb4ce79497bca02186c32311d435bc4731747f2a85a42c2323',
    ('cascade', 'frame'):
        '3dc73d3fc81fdc80e5bda4201caec6e1e0c307bae476199e1bf6e995bd9fbaa7',
    ('cascade', 'empty'):
        '441bad0772979ccb9760dbe919a788b8fd9ef040987934c8fb2894b1654c417f',
    ('cascade', 'tall'):
        'c9f1fa94f47fdfdf3f7d550adc1d5a8f4382cbc752aa1311c47111d20c078041',
    ('cascade', 'two_streams'):
        '57b3fc53f06f692e2915cf9eddc43779e856025f126a86d9bd79cbbda80713ed',
    ('cascade', 'cap'):
        '3b2874f79a586a89eca7d5de1ad1bc92beeafc32c7cad256d559df2f004a8cf6',
    ('cascade', 'exclude'):
        '1d29b27c5d57b3faa3576d25860e72a22cdf68b22ffbdfe1763d9666b176ee9f',
    ('cascade', 'odd'):
        '583d7b6a105f85307086f53cfdb74397457c4e205f8eb825720882d73dc238ba',
    ('cascade', 'stage1'):
        'bcac062f62357a75e01c3f4eedd95438d9e7eda9603c52d3d9b912fb30649aa6',
    ('greedy', 'ties'):
        '5fcfaf5fb8a820a69ecd7cacd2e83feda34be4abaeacac00f9d8029ab2809f14',
    ('greedy', 'gated'):
        '3bfff05af1e0639248816d8be9491d6d2ffe04841d220cedb49ce673321a9fd8',
    ('greedy', 'tall'):
        '33856d125b8e05b211a23f73c5b5f4f1f02e8ae09ff5d2da1fa00a2fbbdf6abb',
    ('greedy', 'wide'):
        'fe7fb84c5f59ae80f0b0b884df15c0ce74feb71ff8356b9657510d3d9125b79a',
    ('greedy', 'two_streams'):
        '826207774e305e49e89c780e817c01a8945955797efadc9c89a158237bd027d1',
    ('greedy', 'contested'):
        '42d06ebcbab0e28d477d53c12c4db77df8148780cc42f21cde59dd73f4c5d9a3',
    ('greedy', 'big'):
        '1ba5555f6a50a217e3283066686c0d040dd1e96eed3391f9ec18b4988b6af510',
    ('finals', 'frame'):
        '2666d7de499d2496be8c004bcf42910165605fb0efbb6afa2b97ec17f292cdb9',
    ('finals', 'dups'):
        '6c4b179c29b3eead02bd41463b8bb09222ca2ed50b347f1af2df051f5934d935',
    ('finals', 'two_streams'):
        '2cd878d8ed1c47fdcd4e0dc072816ddbe3b3c7fa1161fb3ba3c1502ed019862d',
}
CASE_SEEDS = {'auction': 1, 'cascade': 2, 'greedy': 4, 'finals': 5}


def output_sha256(outputs):
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------

# the kernel's rectify cost of n box pairs, appended to the host build
IOU_PROBE = r"""
extern "C" void probe_iou_dist(const float* a, const float* b, float* out,
                               int n) {
  for (int k = 0; k < n; ++k) out[k] = iou_dist(a + 4 * k, b + 4 * k);
}
"""


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    lib = build_host('assoc_solvers', tmp_path_factory, launches=2,
                     extra=IOU_PROBE)
    for entry in (lib.cascade_auction_forward, lib.greedy_match_forward,
                  lib.finals_forward):
        entry.argtypes = asg.FORWARD_ARGTYPES
        entry.restype = ctypes.c_int
    return lib


def set_threads(lib, threads):
    """The host build's team size (None: the card's library, which takes
    the block size of its launch)."""
    if threads is not None:
        lib.set_host_threads(threads)


def host_auction(lib, cost, rv, cv, max_iters=10000, threads=32):
    """``auction_lap`` through the host build (or, ``threads`` None, the
    card's library on CUDA tensors): (row4col, col4row, rounds, bids)."""
    set_threads(lib, threads)
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
    set_threads(lib, threads)
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
    set_threads(lib, threads)
    one = problems[0][0].dim() == 2
    if one:
        problems = [(c[None], r[None], v[None], m)
                    for c, r, v, m in problems]
    outputs, args, keep = asg.greedy_launch_args(problems)
    assert lib.greedy_match_forward(*args) == 0
    return [(a[0], b[0]) for a, b in outputs] if one else outputs


def host_finals(lib, *args, threads=32):
    """``finals_core`` through the host build's finals entry, [S, ...] or
    one stream: (u_det_conf, reid_c4r, rect_c4r)."""
    set_threads(lib, threads)
    one = args[4].dim() == 2
    if one:
        args = args[:4] + tuple(t[None] for t in args[4:])
    outputs, largs, keep = asg.finals_launch_args(*args)
    assert lib.finals_forward(*largs) == 0
    return tuple(o[0] for o in outputs) if one else outputs


def torch_finals(kind, seed=5):
    args = finals_case(kind, seed)
    return args[:4] + tuple(T(a) for a in args[4:])


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
    # more live rows than live columns, all of them allowed somewhere
    cost, rv, cv, _ = auction_case('crowded')
    live = cost[0][rv[0]][:, cv[0]] < INF
    assert rv.sum() > 3 * cv.sum() and live.any(1).all()
    # 'displaced': each row of DISPLACED_ROWS bids on column 0 alone, which
    # one of them keeps; row 3 takes column 1. A row priced out of column 0
    # (its price above 4 after the first bid) bids the column of its
    # largest micro-bias among those no one bid on (price 0): a dead one,
    # owned by a pre-assigned dead row, for each of the three rows (the
    # noise is the plain version's, in float32)
    n, bias = 32, F32(1e-4)
    jj = np.arange(2, n)
    for r in DISPLACED_ROWS:
        z = F32(-asg.FORBID) + bias * ((r * 2654435761 + jj * 40503)
                                       % 65536 / F32(65536)).astype(F32)
        assert jj[int(np.argmax(z))] >= 4, r
    r4c, c4r, rounds, _ = host_auction(host_kernel, *map(T, auction_case(
        'displaced')[:3]))
    assert int((c4r[0] >= 0).sum()) == 2 and rounds[0, 0, 0] > 2
    # 'odd' rows are not 16-byte multiples; the stage-1 costs contend
    assert (23 * 19) % 4 and cascade_case('odd')[0][0].shape[1:] == (27, 21)
    _, _, rounds, _ = host_auction(host_kernel, *map(T, auction_case(
        'stage1', 1)[:3]))
    assert rounds.sum() > 100
    # 'exclude': the IoU stage's rows are mostly the first stage's
    _, masks, *_ = cascade_case('exclude')
    assert (masks[0] & masks[N_DEPTH]).sum() >= 0.5 * masks[0].sum() > 8
    # the contested greedy and the finals' rectify duplicates match often
    got = host_greedy(host_kernel, [(T(c), T(r), T(v), m) for c, r, v, m in
                                    greedy_case('contested', 4)])
    assert all(int((c4r >= 0).sum()) >= 30 for _, c4r in got)
    assert int((ttr.finals_reference(*torch_finals('dups'))[2] >= 0).sum()) \
        >= 4


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


def case_outputs(lib, key, threads=32, device='cpu'):
    """Every output of the seeded case ``key`` of ``OUTPUT_SHA256`` through
    ``lib``: the host build at ``threads`` threads, or (``threads`` None)
    the card's library on ``device``."""
    what, kind = key
    seed = CASE_SEEDS[what]

    def to(t):
        return t.to(device) if isinstance(t, torch.Tensor) else t
    if what == 'auction':
        cost, rv, cv, max_iters = (T(a) if isinstance(a, np.ndarray) else a
                                   for a in auction_case(kind, seed))
        return host_auction(lib, to(cost), to(rv), to(cv), max_iters,
                            threads)
    if what == 'cascade':
        args, max_iters = torch_cascade(cascade_case(kind, seed))
        args = (tuple(map(to, args[0])), tuple(map(to, args[1])), *args[2:4],
                to(args[4]), to(args[5]))
        return host_cascade(lib, *args, max_iters=max_iters, threads=threads)
    if what == 'greedy':
        problems = [(to(T(c)), to(T(r)), to(T(v)), m)
                    for c, r, v, m in greedy_case(kind, seed)]
        return [t for pair in host_greedy(lib, problems, threads)
                for t in pair]
    return host_finals(lib, *map(to, torch_finals(kind, seed)),
                       threads=threads)


@pytest.mark.parametrize('key', OUTPUT_SHA256, ids=lambda k: '-'.join(k))
def test_host_outputs_equal_the_first_design(host_kernel, key):
    """Every output of the host build, to the bit, is what the first design
    gave on the same case (``OUTPUT_SHA256``), with a team of one warp and
    one of three (a lone bidder's rounds on warp 0 while the others wait)."""
    for threads in (32, 96):
        assert output_sha256(case_outputs(host_kernel, key, threads)) \
            == OUTPUT_SHA256[key], threads


@pytest.mark.parametrize('threads', [64, 128, 160])
def test_host_team_size_changes_no_bit(host_kernel, threads):
    """The team's size (two, four or five warps, all but warp 0 waiting
    while it runs a lone bidder's rounds) changes no bit of any auction or
    cascade, rounds and bids included."""
    for key in OUTPUT_SHA256:
        if key[0] in ('auction', 'cascade'):
            assert output_sha256(case_outputs(host_kernel, key, threads)) \
                == OUTPUT_SHA256[key], key


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in FINALS_KINDS]
                         + [('dups', 64)])
def test_host_finals_equal_plain_version(host_kernel, kind, threads):
    """The finals entry (masks, rectify cost and both greedy matches in
    one launch) equals ``finals_reference`` bit for bit."""
    args = torch_finals(kind)
    got = host_finals(host_kernel, *args, threads=threads)
    want = ttr.finals_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int((got[2] >= 0).sum()) > 0 and int((got[1] >= 0).sum()) > 0


def test_host_rectify_cost_is_bbox_ious(host_kernel):
    """The kernel's rectify cost is ``1 - bbox_ious`` to the bit on boxes
    that overlap, nest, touch, miss each other, are degenerate or hold a
    NaN."""
    rng = np.random.default_rng(11)
    n = 4000
    a = rng.uniform(0, 200, (n, 2))
    a = np.concatenate([a, a + rng.uniform(-5, 90, (n, 2))], 1)
    b = a + rng.normal(0, 20, (n, 4))
    b[::7] = a[::7]                                  # the same box
    b[1::7, :2] = a[1::7, 2:] + 1                    # touching corners
    b[2::7] = np.round(b[2::7])
    a[3::97, 1] = np.nan
    a, b = a.astype(F32), b.astype(F32)
    out = np.empty(n, F32)
    f = ctypes.POINTER(ctypes.c_float)
    host_kernel.probe_iou_dist(a.ctypes.data_as(f), b.ctypes.data_as(f),
                               out.ctypes.data_as(f), n)
    want = np.array([tdist.iou_dist(T(a[k:k + 1]), T(b[k:k + 1]))[0, 0]
                     for k in range(n)], F32)
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))
    assert 0 < (want < 1).mean() < 1 and (want < 0.2).sum() > 100


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
    """``asg.cascade_auction``, ``asg.greedy_match`` and
    ``tracker.finals_core`` (its finals entry) through the host build."""
    def cascade(costs, masks, cost_of, exclude, u_det, col4row,
                eps_final=1e-2, max_iters=10000, forbid=asg.FORBID):
        return host_cascade(lib, costs, masks, cost_of, exclude, u_det,
                            col4row, eps_final, max_iters, forbid,
                            threads)[:2]
    monkeypatch.setattr(asg, 'cascade_auction', cascade)
    monkeypatch.setattr(asg, 'greedy_match',
                        lambda problems: host_greedy(lib, problems, threads))
    monkeypatch.setattr(ttr, 'finals_core', lambda *args: host_finals(
        lib, *args, threads=threads))


def test_plain_and_host_match_jax(host_kernel, monkeypatch):
    """The whole cascade and the finals, plain and host build (the finals
    entry, its rectify cost computed in the kernel), against the JAX
    package's ``_stages_scan_core`` and ``_finals_core``: every integer
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
    greedy call (of two problems) a frame for all of a call's streams, and
    the finals entry of the host build equal to ``finals_reference`` on the
    same arguments."""
    from fastmot_tpu_torch.detector import MAX_DETS
    from fastmot_tpu_torch.parallel import StreamTracker
    calls = []
    cascade, greedy = asg.cascade_reference, asg.greedy_match_reference
    finals = ttr.finals_reference

    def checked_finals(*args):
        got = host_finals(host_kernel, *args)
        want = finals(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        calls.append(('finals', tuple(args[4].shape[:-2])))
        return want

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
    monkeypatch.setattr(ttr, 'finals_reference', checked_finals)
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
    assert calls == [('cascade', (2,)), ('greedy', 2), ('finals', (2,))] * 3
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
    assert calls == [('cascade', ()), ('greedy', 2), ('finals', ())]


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


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'size', 'streams',
                                   'reid'])
def test_finals_launch_args_raise_on_each_fault(fault):
    args = list(torch_finals('two_streams'))
    asg.finals_launch_args(*args)                    # the unbroken call
    if fault == 'dtype':
        args[6] = args[6].long()                     # ages
    elif fault == 'shape':
        args[5] = args[5][:, :-1]                    # t_valid
    elif fault == 'size':
        args[4] = torch.zeros((2, 130, 4))           # tlbrs
    elif fault == 'streams':
        args[14] = args[14][:1]                      # col4row_final
    elif fault == 'reid':
        args[10] = args[10][0]                       # reid_cost
    with pytest.raises(ValueError, match='assoc_solvers: '):
        asg.finals_launch_args(*args)


def test_finals_core_takes_the_plain_version_on_the_cpu_only():
    args = torch_finals('frame')
    got, want = ttr.finals_core(*args), ttr.finals_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match='CUDA tensors'):
        asg.greedy_finals(*args)
    meta = args[:4] + tuple(t.to('meta') for t in args[4:])
    with pytest.raises(ValueError, match='unsupported device'):
        ttr.finals_core(*meta)


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
@pytest.mark.parametrize('kind', FINALS_KINDS)
def test_kernel_finals_match_plain_version(cuda, kind):
    args = torch_finals(kind)
    before = asg.greedy_match.launches, asg.greedy_finals.launches
    got = ttr.finals_core(*args[:4], *(t.to(cuda) for t in args[4:]))
    torch.cuda.synchronize()
    assert (asg.greedy_match.launches, asg.greedy_finals.launches) \
        == (before[0] + 1, before[1] + 1)
    assert all(torch.equal(g.cpu(), w) for g, w in
               zip(got, ttr.finals_reference(*args)))


@pytest.mark.cuda
def test_kernel_outputs_equal_the_first_design(cuda):
    """Every seeded case on the card gives the first design's outputs
    (``OUTPUT_SHA256``), rounds and bids included."""
    lib = asg.assoc_solvers_library()
    for key in OUTPUT_SHA256:
        assert output_sha256(case_outputs(lib, key, None, cuda)) \
            == OUTPUT_SHA256[key], key


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
