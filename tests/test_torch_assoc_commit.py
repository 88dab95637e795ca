"""The association commit kernel of the port (``csrc/assoc_commit.cu``,
wrapper ``ops.assoc_commit.assoc_commit``, behind ``tracker.commit_core``
and ``tracker.commit_batch`` on the card): the lifecycle decisions, the slot
and history allocation and the state commit of ``tracker.commit_part`` for
every stream of a call in one call of the kernel (its decisions a block a
stream, the inputs staged in shared memory, the matched Kalman updates 8
lanes a slot, then its wide rows a warp a row).

On the CPU the kernel's own source is built for the host with g++ through
tests/cuda_host_shim.py (a launch's blocks in turn on a team of host
threads; the ballots meetings of a warp's 32; ``-ffp-contract=off`` as the
card's build runs under ``-fmad=false``; the kernel strides its loops by
the block's thread count and takes whole warps, so the tests run it with
32, 64 and 96 threads a block). On seeded states at S = 1 and S = 3 that
take every branch (merges, duplicates, reinstates, creations beyond the free
slots so that ``n_dropped`` > 0, out-of-frame exits, history saves that
steal slots, evictions beyond ``history_size``) the host build is held to
the plain version (``commit_part``, under ``vmap`` for several streams) and
to the JAX package's ``_commit_part``:

- every integer and boolean output, the info vector's integer fields and
  the feature sums (elementwise adds in the plain version's order) equal;
- means within ``MEAN_PX`` px and covariances within ``COV_REL`` of a
  track's largest entry: the kernel solves the Kalman gain through JAX's
  unrolled Cholesky, the plain version through LAPACK's LU, in ATen's sum
  order;
- boxes (the means rounded) equal but where a mean lies within
  ``HALF_PX`` of a half pixel, where the two roundings may differ by one
  (counted; none on these cases), and ``out_of_frame`` equal (an IoS within
  1e-5 of 0.5 could flip it; none does here).

Every output of every seeded call is, to the bit, what the first design of
the kernel gave (``OUTPUT_SHA256``); so is every output of the edge cases
(``EDGE_KINDS``, at their own block sizes: 128 slots on one warp, fewer
lanes than 8 a slot; two tracks naming one rectify target; every slot held
so that every creation and reinstate is dropped; sizes that are multiples
of nothing, at two streams) against the sha256 a host build of the first
design's source gave (``EDGE_SHA256``).

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the CPU test that needs it):

    python -m pytest tests/test_torch_assoc_commit.py -m cuda
"""
import hashlib

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.kalman import KalmanConfig
from fastmot_tpu_torch.ops import assoc_commit as ac

from .cuda_host_shim import build_host

F32 = np.float32
MEAN_PX = 1e-3
COV_REL = 1e-4
HALF_PX = 1e-3
CONFIRM, MAX_AGE = 3, 6
FRAME = np.array([0, 0, 639, 479], F32)
FRAME_ID = 37
# (streams, tracks, detections, history slots, feature width, keypoints,
# history_size) of each case
CASES = {'frame': (1, 32, 32, 16, 16, 4, 12),
         'contested': (1, 32, 32, 16, 16, 4, 10),
         'three_streams': (3, 32, 32, 16, 24, 4, 12),
         'full_width': (1, 128, 128, 64, 512, 32, 50),
         'contested_full': (1, 128, 128, 64, 512, 32, 50)}
# the edge cases' own shapes: sizes that are not multiples of 4, 8 or 16
# (no 16-byte row is aligned), the second of two streams contested
EDGE_SHAPES = {'odd_sizes': (2, 37, 29, 11, 20, 3, 9)}
# the info vector's fields (MultiTracker._assoc_layout), by length
INFO_INT = ('match_det', 'merge_src', 'dup', 'del_unconf', 'retire_age',
            'out_of_frame', 'hist_dst', 'reinstate_hist', 'create_det',
            'new_ages', 'new_hits', 'new_labels', 'new_valid', 'feat_ok')


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_assoc_solvers.py's fixture
    of the name: the tier-1 run puts six workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_info(info, t, h):
    """An info vector [n] as a dict of its fields (numpy)."""
    info = np.asarray(info)
    out, off = {'head': info[:4]}, 4
    for name in INFO_INT:
        out[name] = info[off:off + t]
        off += t
    out['evict'] = info[off:off + h]
    off += h
    for name, width in (('next_tlbrs', 4), ('means', 8), ('covs', 64)):
        out[name] = info[off:off + t * width].reshape(t, -1)
        off += t * width
    assert off == info.size == ac.info_size(t, h)
    return out


def spd(rng, n, scale):
    a = rng.normal(0, 1, (n, 8, 8))
    return (a @ a.transpose(0, 2, 1) * scale
            + np.eye(8) * scale * 4).astype(F32)


def one_stream(rng, t, d, h, f, k, contested):
    """One stream's (state, hist, dets, emb, cascade_out), numpy: tracks in
    and beside the 640 x 480 frame, detections on some of them (a matching,
    some outside the frame), a reID matching of history rows to unmatched
    detections, rectify pairs (unmatched active tracks onto matched
    inactive ones: merges where the matched one ended first, duplicates
    otherwise). ``contested``: nearly every slot valid and many
    creations (so that some are dropped), many saves into a full history
    (so that they steal and the store evicts)."""
    n_valid = t - 2 if contested else (3 * t) // 4
    valid = np.zeros(t, bool)
    valid[rng.permutation(t)[:n_valid]] = True
    xy = rng.uniform([-60, -40], [620, 460], (t, 2))
    wh = rng.uniform(20, 90, (t, 2))
    means = np.concatenate([xy, xy + wh, rng.normal(0, 2, (t, 4))], 1)
    means = means.astype(F32)
    covs = spd(rng, t, 2.0)
    tlbrs = np.round(means[:, :4]).astype(F32)
    ages = rng.integers(0, 9, t).astype(np.int32)
    hits = rng.integers(0, 7, t).astype(np.int32)
    if contested:          # confirmed and young but for a few: few slots free
        ages = rng.integers(0, 5, t).astype(np.int32)
        ages[rng.permutation(t)[:3]] = 7
        hits = rng.integers(CONFIRM, 7, t).astype(np.int32)
        hits[rng.permutation(t)[:2]] = 0
    labels = rng.integers(0, 2, t).astype(np.int32)
    start_f = rng.integers(0, 30, t).astype(np.int32)
    end_f = (start_f + rng.integers(0, 6, t)).astype(np.int32)
    lost = valid & (rng.uniform(size=t) < (0.3 if contested else 0.1))
    inl = rng.uniform(0.2, 1, t).astype(F32)
    kps = rng.uniform(0, 600, (t, k, 2)).astype(F32)
    kpv = rng.uniform(size=(t, k)) < 0.7
    feat_sum = rng.normal(0, 1, (t, f)).astype(F32)
    feat_count = rng.integers(0, 6, t).astype(F32)
    state = [means, covs, tlbrs, valid, ages, hits, labels, start_f, end_f,
             lost, inl, kps, kpv, feat_sum, feat_count]

    h_valid = rng.uniform(size=h) < (0.95 if contested else 0.6)
    hist = [rng.normal(0, 1, (h, f)).astype(F32),
            rng.integers(0, 5, h).astype(F32),
            rng.integers(0, 2, h).astype(np.int32), h_valid,
            rng.integers(0, 12, h).astype(np.int32),     # LRU ties
            rng.integers(0, 7, h).astype(np.int32)]

    # detections: on a matched set of tracks, then free ones, some of them
    # beyond the frame's right edge
    order = rng.permutation(np.flatnonzero(valid))
    n_match = min(len(order) // 2, d // 3)
    matched_t = order[:n_match]
    d_tlbrs = np.zeros((d, 4), F32)
    d_tlbrs[:n_match] = tlbrs[matched_t] + rng.normal(0, 2, (n_match, 4))
    rest = d - n_match
    dxy = rng.uniform([0, 0], [600, 440], (rest, 2))
    dxy[rng.uniform(size=rest) < 0.2, 0] += 560      # beyond x = 639
    dwh = rng.uniform(20, 80, (rest, 2))
    d_tlbrs[n_match:] = np.concatenate([dxy, dxy + dwh], 1)
    d_tlbrs = np.round(d_tlbrs).astype(F32)
    n_dvalid = d - 3
    d_valid = np.arange(d) < n_dvalid
    d_labels = np.where(d_valid, rng.integers(0, 2, d), -1).astype(np.int32)
    d_conf = np.where(d_valid, rng.uniform(0.3, 1, d), 0).astype(F32)
    emb = rng.normal(0, 1, (d, f)).astype(F32)
    det_perm = rng.permutation(d)          # detection rows shuffled
    inv = np.argsort(det_perm)
    d_tlbrs, d_valid = d_tlbrs[det_perm], d_valid[det_perm]
    d_labels, d_conf = d_labels[det_perm], d_conf[det_perm]
    emb = emb[det_perm]
    dets = [d_tlbrs, d_labels, d_conf, d_valid]

    col4row = np.full(t, -1, np.int32)
    col4row[matched_t] = inv[np.arange(n_match)]
    used = np.zeros(d, bool)
    used[col4row[col4row >= 0]] = True
    occluded = rng.uniform(size=d) < 0.15
    u_det_conf = ~used & d_valid & (d_conf >= 0.5)
    # reID: history rows onto unmatched detections, one to one
    free_d = rng.permutation(np.flatnonzero(~used & d_valid))
    reid_c4r = np.full(h, -1, np.int32)
    n_reid = min(len(free_d) // 3, h // 2)
    reid_rows = rng.permutation(h)[:n_reid]
    reid_c4r[reid_rows] = free_d[:n_reid]
    hist[1][reid_rows[:max(1, n_reid // 2)]] = 3.0      # reID-able counts
    hist[3][reid_rows[:max(1, n_reid // 2)]] = True
    # rectify: unmatched active tracks onto matched ones, one to one
    unmatched = np.flatnonzero(valid & (col4row < 0) & (ages < 2))
    rect_c4r = np.full(t, -1, np.int32)
    n_rect = min(len(unmatched), len(matched_t)) // 2
    rect_c4r[unmatched[:n_rect]] = matched_t[:n_rect]
    for a, (i, j) in enumerate(zip(unmatched[:n_rect], matched_t[:n_rect])):
        if a % 2 == 0:               # a merge: j ended before i started
            end_f[j] = start_f[i] - 1 - rng.integers(0, 3)
        else:                        # a duplicate
            end_f[j] = max(end_f[j], start_f[i])
    cascade = [occluded, col4row, u_det_conf, reid_c4r, rect_c4r]
    return state, hist, dets, emb, cascade


def commit_case(kind, seed=0, streams=None):
    """(states, hists, dets, embs, cascade_out, history_size) of a case,
    numpy with a leading stream axis (``streams`` of them in place of the
    case's own count: chip_smoke.py phase 20's 8 contested streams)."""
    s, t, d, h, f, k, history_size = CASES.get(kind) or EDGE_SHAPES[kind]
    rng = np.random.default_rng(seed)
    streams = [one_stream(rng, t, d, h, f, k, kind.startswith('contested')
                          or (kind in ('three_streams', 'odd_sizes')
                              and i == 1))
               for i in range(streams or s)]
    return tuple(tuple(np.stack(x) for x in zip(*(st[g] for st in streams)))
                 if g != 3 else np.stack([st[3] for st in streams])
                 for g in range(5)) + (history_size,)


def torch_case(case):
    states, hists, dets, embs, casc, history_size = case
    return (tuple(T(a) for a in states), tuple(T(a) for a in hists),
            tuple(T(a) for a in dets), T(embs), tuple(T(a) for a in casc),
            history_size)


def plain(case):
    states, hists, dets, embs, casc, history_size = torch_case(case)
    return ac.commit_reference(KalmanConfig(), CONFIRM, MAX_AGE,
                               history_size, states, hists, dets, embs,
                               FRAME_ID, T(FRAME), casc)


# the kernel's bytes of staged inputs, appended to the host build
STAGED_PROBE = '''
extern "C" int staged_bytes_probe(int t, int d, int h) {
  return staged_layout(t, d, h, nullptr);
}
'''


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    return ac.declare(build_host('assoc_commit', tmp_path_factory,
                                 extra=STAGED_PROBE))


def host_commit(lib, case, threads=32, device='cpu'):
    """``assoc_commit`` through the host build (or, ``threads`` None, the
    card's library on CUDA tensors)."""
    if threads is not None:
        lib.set_host_threads(threads)
    states, hists, dets, embs, casc, history_size = (
        tuple(a.to(device) for a in x) if isinstance(x, tuple)
        else x.to(device) if isinstance(x, torch.Tensor) else x
        for x in torch_case(case))
    outputs, args = ac.commit_launch_args(
        KalmanConfig(), CONFIRM, MAX_AGE, history_size, states, hists, dets,
        embs, FRAME_ID, T(FRAME).to(device), casc)
    assert lib.assoc_commit_forward(*args) == 0
    return outputs


def half_pixel(means):
    """Where a mean's first four entries lie within HALF_PX of a half
    pixel (their rounding may go either way)."""
    m = np.asarray(means)[..., :4]
    return np.abs(np.abs(m - np.floor(m)) - 0.5) < HALF_PX


def assert_commit_close(got, want, tag):
    """``got`` against ``want`` (each (states, hists, infos) of [S, ...]
    numpy-convertible arrays) at this file's rules; returns the count of
    boxes that differ at a half pixel."""
    g_state, g_hist, g_info = (tuple(np.asarray(a) for a in x)
                               if isinstance(x, tuple) else np.asarray(x)
                               for x in got)
    w_state, w_hist, w_info = (tuple(np.asarray(a) for a in x)
                               if isinstance(x, tuple) else np.asarray(x)
                               for x in want)
    for i in (3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 10):
        np.testing.assert_array_equal(g_state[i], w_state[i],
                                      err_msg=f'{tag} state[{i}]')
    for i in range(6):
        np.testing.assert_array_equal(g_hist[i], w_hist[i],
                                      err_msg=f'{tag} hist[{i}]')
    np.testing.assert_allclose(g_state[0], w_state[0], rtol=0, atol=MEAN_PX,
                               err_msg=f'{tag} means')
    scale = np.abs(w_state[1]).max(axis=(-1, -2), keepdims=True)
    assert np.all(np.abs(g_state[1] - w_state[1]) <= COV_REL * scale), \
        f'{tag} covs'
    near = half_pixel(w_state[0])
    flips = int((g_state[2] != w_state[2]).sum())
    assert np.all((g_state[2] == w_state[2]) | near), f'{tag} boxes'
    t, h = g_state[0].shape[1], g_hist[0].shape[1]
    for s in range(g_info.shape[0]):
        gi, wi = split_info(g_info[s], t, h), split_info(w_info[s], t, h)
        for name in ('head',) + INFO_INT + ('evict',):
            np.testing.assert_array_equal(gi[name], wi[name],
                                          err_msg=f'{tag} info {name}')
        np.testing.assert_allclose(gi['means'], wi['means'], rtol=0,
                                   atol=MEAN_PX)
        sc = np.abs(wi['covs']).max(-1, keepdims=True)
        assert np.all(np.abs(gi['covs'] - wi['covs']) <= COV_REL * sc)
        assert np.all((gi['next_tlbrs'] == wi['next_tlbrs'])
                      | half_pixel(wi['means']))
    return flips


def branches(result):
    """What a commit's result exercises, counted over its streams."""
    states, hists, infos = result
    t, h = states[0].shape[1], hists[0].shape[1]
    out = dict(merges=0, dups=0, reinstates=0, dropped=0, oof=0, stolen=0,
               evicted=0, saves=0, creations=0, matches=0)
    for s in range(infos.shape[0]):
        i = split_info(infos[s].numpy(), t, h)
        out['merges'] += int((i['merge_src'] >= 0).sum())
        out['dups'] += int(i['dup'].sum())
        out['reinstates'] += int((i['reinstate_hist'] >= 0).sum())
        out['dropped'] += int(i['head'][1])
        out['stolen'] += int(i['head'][2])
        out['oof'] += int(i['out_of_frame'].sum())
        out['evicted'] += int(i['evict'].sum())
        out['saves'] += int((i['hist_dst'] >= 0).sum())
        out['creations'] += int((i['create_det'] >= 0).sum())
        out['matches'] += int((i['match_det'] >= 0).sum())
    return out


CASE_SEEDS = {'frame': 1, 'contested': 2, 'three_streams': 3,
              'full_width': 4, 'contested_full': 5}


def output_sha256(outputs):
    states, hists, info = outputs
    h = hashlib.sha256()
    for t in tuple(states) + tuple(hists) + (info,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# every output of each case's call, as the first design of the kernel gave
# it (the case at CASE_SEEDS)
OUTPUT_SHA256 = {
    'contested_full':
        '2216338479e3b49e77745fe2c40486b4b51fb110e8e7f990a0829d894b37ec6b',
    'contested':
        '88630b30d499c1e8d37bf2bfa38b33979eebaa498e73673de579dcd4faf6861e',
    'frame':
        'f7a3ec0a3209c1d4f4ccf14dc66fda84f3c248d053ba3722cc55abe8f4b7c400',
    'full_width':
        '38940eae1f041b846c87747d1b92f717993d7ae05adb40eac7bc3aa101234abd',
    'three_streams':
        '3e77a7e1193cefdc48eeb3fd84948c6ade7e76ccc11088b04ad7cf650bcecd43',
}


# cases at the kernel's edges, each with the block's thread count its host
# build runs: 128 slots of a contested stream on one warp (fewer lanes than
# 8 a slot), two tracks naming one rectify target (the plain scatter's last
# write), every slot held so that every reinstate and creation is dropped,
# and sizes that are multiples of nothing (37 slots, 29 detections, 11
# history slots, 20 features, 3 keypoints) at 2 streams
EDGE_THREADS = {'few_lanes': 32, 'duplicate_rect': 64, 'no_room': 32,
                'odd_sizes': 96}
EDGE_KINDS = tuple(EDGE_THREADS)


def edge_case(kind):
    """An edge case's (states, hists, dets, embs, cascade_out,
    history_size), numpy with a leading stream axis."""
    if kind == 'few_lanes':
        return commit_case('contested_full', 11)
    if kind == 'odd_sizes':
        return commit_case('odd_sizes', 14)
    if kind == 'duplicate_rect':
        states, hists, dets, embs, casc, history_size = commit_case(
            'frame', CASE_SEEDS['frame'])
        rect = casc[4].copy()
        i0, i1 = np.flatnonzero(rect[0] >= 0)[:2]
        rect[0, i1] = rect[0, i0]
        states[8][0, rect[0, i0]] = -5    # the target ended first: merges
        return (states, hists, dets, embs, tuple(casc[:4]) + (rect,),
                history_size)
    if kind == 'no_room':
        states, hists, dets, embs, casc, history_size = commit_case(
            'contested', 12)
        states[3][:] = True                   # every slot held: confirmed,
        states[4][:] = 0                      # young, no rectify match
        states[5][:] = np.maximum(states[5], CONFIRM)
        rect = np.full_like(casc[4], -1)
        return (states, hists, dets, embs, tuple(casc[:4]) + (rect,),
                history_size)
    raise ValueError(kind)


# every output of each edge case's call, as a host build of the first
# design's source gave it
EDGE_SHA256 = {
    'few_lanes':
        'b3a474194f53a08eba919d20d2bb19d26b1c688a6833a03903f037d2b3e40eb3',
    'duplicate_rect':
        '70b4b8d4042f0f40c987adb1e695d33fc29e4b1f2c18920b04de6d312792654c',
    'no_room':
        '2045392db41e1c0eae1f2d3bb5a6351605f26ed78107214895f7190ce0d8cb93',
    'odd_sizes':
        '3378f783729e73b200da22d80f5afb9e5de2fc4d5907490719169f6fba08ed3f',
}


def test_cases_take_every_branch():
    """Between them the cases merge, duplicate, reinstate, drop creations
    beyond the free slots, exit the frame, save into the history stealing
    slots, and evict beyond history_size; each contested case (32 and
    128 slots) does all of it alone."""
    total = {}
    for kind in CASES:
        case = commit_case(kind, CASE_SEEDS[kind])
        got = branches(plain(case))
        for key, n in got.items():
            total[key] = total.get(key, 0) + n
        if kind.startswith('contested'):
            assert all(n > 0 for n in got.values()), (kind, got)
    assert all(n > 0 for n in total.values()), total


def test_matchings_are_one_to_one():
    """The scatters of the commit rely on unique indices: the cascade's
    col4row, the reID and the rectify matchings of every case (as the
    greedy finals give them) name each detection or track at most once,
    and the kernel's merge scan takes the plain scatter's last write if
    not (``duplicate_rect``)."""
    for kind in CASES:
        _, _, _, _, casc, _ = commit_case(kind, CASE_SEEDS[kind])
        for arr in (casc[1], casc[3], casc[4]):
            for row in arr:
                named = row[row >= 0]
                assert len(np.unique(named)) == len(named)


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in CASES]
                         + [('contested', 64), ('three_streams', 96)])
def test_host_commit_matches_plain_version(host_kernel, kind, threads):
    case = commit_case(kind, CASE_SEEDS[kind])
    got = host_commit(host_kernel, case, threads)
    assert assert_commit_close(got, plain(case), kind) == 0


def test_duplicate_rect_takes_the_last_write(host_kernel):
    """Two tracks naming one rectify target (which the finals never give):
    the kernel's merge source is the later track, as the plain version's
    scatter writes it on the CPU."""
    case = edge_case('duplicate_rect')
    rect = case[4][4]
    i0, i1 = np.flatnonzero(rect[0] >= 0)[:2]
    assert rect[0, i0] == rect[0, i1]
    got = host_commit(host_kernel, case)
    want = plain(case)
    i = split_info(want[2][0].numpy(), 32, 16)
    assert i['merge_src'][rect[0, i0]] == i1
    assert assert_commit_close(got, want, 'duplicate rect') == 0


@pytest.mark.parametrize('kind', EDGE_KINDS)
def test_host_edge_cases(host_kernel, kind):
    """Each edge case at its block size: the plain version at this file's
    rules, and the outputs a host build of the first design's source gave,
    bit for bit."""
    case = edge_case(kind)
    got = host_commit(host_kernel, case, EDGE_THREADS[kind])
    assert assert_commit_close(got, plain(case), kind) == 0
    assert output_sha256(got) == EDGE_SHA256[kind]


def test_staged_bytes_match_the_kernel(host_kernel):
    """``ops.assoc_commit.staged_bytes``, which chip_smoke.py prints, is
    the kernel's own count of its staged inputs' shared memory."""
    for t, d, h in ((128, 128, 64), (37, 29, 11), (1, 1, 1), (256, 256,
                                                              256)):
        assert host_kernel.staged_bytes_probe(t, d, h) \
            == ac.staged_bytes(t, d, h)


def test_no_room_drops_every_creation():
    """With every slot held, nothing is created or reinstated: every
    request is counted in n_dropped; the saves still steal and evict."""
    got = branches(plain(edge_case('no_room')))
    assert got['creations'] == got['reinstates'] == 0
    assert got['dropped'] > 0 and got['stolen'] > 0 and got['evicted'] > 0


def test_host_one_stream_without_the_axis(host_kernel):
    """``commit_launch_args`` on one stream's tensors without the stream
    axis (``tracker.commit_core``'s call) gives the outputs of the same
    stream with the axis, bit for bit, without it."""
    case = commit_case('contested', CASE_SEEDS['contested'])
    batched = host_commit(host_kernel, case)
    states, hists, dets, embs, casc, history_size = torch_case(case)
    outputs, args = ac.commit_launch_args(
        KalmanConfig(), CONFIRM, MAX_AGE, history_size,
        tuple(a[0] for a in states), tuple(a[0] for a in hists),
        tuple(a[0] for a in dets), embs[0], FRAME_ID, T(FRAME),
        tuple(a[0] for a in casc))
    assert host_kernel.assoc_commit_forward(*args) == 0
    for a, b in zip(outputs[0] + outputs[1] + (outputs[2],),
                    batched[0] + batched[1] + (batched[2],)):
        assert a.shape == b.shape[1:] and torch.equal(a, b[0])


@pytest.mark.parametrize('kind', sorted(CASES))
def test_host_outputs_equal_the_first_design(host_kernel, kind):
    case = commit_case(kind, CASE_SEEDS[kind])
    assert output_sha256(host_commit(host_kernel, case)) \
        == OUTPUT_SHA256[kind]


def test_plain_and_host_match_jax(host_kernel):
    """The plain version and the host build against the JAX package's
    ``_commit_part`` (one stream at a time) on the contested, the
    full-width and the three-stream cases, at this file's rules."""
    import jax.numpy as jnp
    from fastmot_tpu import kalman as jkf
    from fastmot_tpu import tracker as jtr
    for kind in ('contested', 'contested_full', 'full_width',
                 'three_streams'):
        case = commit_case(kind, CASE_SEEDS[kind])
        states, hists, dets, embs, casc, history_size = case
        want = []
        for s in range(embs.shape[0]):
            want.append(jtr._commit_part(
                jkf.KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                tuple(jnp.asarray(a[s]) for a in states),
                tuple(jnp.asarray(a[s]) for a in hists),
                *(jnp.asarray(a[s]) for a in dets), jnp.asarray(embs[s]),
                jnp.int32(FRAME_ID), jnp.asarray(FRAME),
                tuple(jnp.asarray(a[s]) for a in casc)))
        want = (tuple(np.stack([np.asarray(w[0][i]) for w in want])
                      for i in range(15)),
                tuple(np.stack([np.asarray(w[1][i]) for w in want])
                      for i in range(6)),
                np.stack([np.asarray(w[2]) for w in want]))
        assert assert_commit_close(plain(case), want, f'{kind} plain') == 0
        assert assert_commit_close(host_commit(host_kernel, case), want,
                                   f'{kind} host') == 0


def test_tracker_routes_on_the_cpu_to_the_plain_version(monkeypatch):
    """``commit_core`` and ``commit_batch`` take ``commit_part`` on CPU
    tensors and load no kernel; on another device they raise."""
    monkeypatch.setattr(ac, 'assoc_commit_library', lambda: pytest.fail(
        'the kernel library was loaded for CPU tensors'))
    case = commit_case('three_streams', CASE_SEEDS['three_streams'])
    states, hists, dets, embs, casc, history_size = torch_case(case)
    want = plain(case)
    got = ttr.commit_batch(KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                           states, hists, dets, embs, FRAME_ID, T(FRAME),
                           casc)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1] + (got[2],),
                                                 want[0] + want[1]
                                                 + (want[2],)))
    one = ttr.commit_core(KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                          tuple(a[1] for a in states),
                          tuple(a[1] for a in hists),
                          *(a[1] for a in dets), embs[1], FRAME_ID, T(FRAME),
                          tuple(a[1] for a in casc))
    assert torch.equal(one[2], want[2][1])
    meta = tuple(torch.empty(a.shape, dtype=a.dtype, device='meta')
                 for a in states)
    with pytest.raises(ValueError, match='unsupported device'):
        ttr.commit_batch(KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                         meta, hists, dets, embs, FRAME_ID, T(FRAME), casc)
    with pytest.raises(ValueError, match='unsupported device'):
        ac.assoc_commit(KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                        meta, hists, dets, embs, FRAME_ID, T(FRAME), casc)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'size', 'fields',
                                   'contiguous'])
def test_commit_launch_args_raise_on_each_fault(fault):
    case = commit_case('frame', CASE_SEEDS['frame'])
    states, hists, dets, embs, casc, history_size = torch_case(case)
    states = list(states)
    if fault == 'dtype':
        states[4] = states[4].to(torch.int64)
    elif fault == 'shape':
        states[5] = states[5][:, :-1]
    elif fault == 'size':
        states = [torch.cat([a] * 9, 1) for a in states]
    elif fault == 'fields':
        states = states[:-1]
    else:
        states[0] = states[0].transpose(0, 1)
    with pytest.raises(ValueError, match='assoc_commit'):
        ac.commit_launch_args(KalmanConfig(), CONFIRM, MAX_AGE,
                              history_size, tuple(states), hists, dets, embs,
                              FRAME_ID, T(FRAME), casc)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', sorted(CASES))
def test_kernel_matches_plain_version(cuda, kind):
    case = commit_case(kind, CASE_SEEDS[kind])
    states, hists, dets, embs, casc, history_size = (
        tuple(a.to(cuda) for a in x) if isinstance(x, tuple)
        else x.to(cuda) if isinstance(x, torch.Tensor) else x
        for x in torch_case(case))
    before = ac.assoc_commit.launches
    got = ttr.commit_batch(KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                           states, hists, dets, embs, FRAME_ID,
                           T(FRAME).to(cuda), casc)
    torch.cuda.synchronize()
    assert ac.assoc_commit.launches == before + 1
    got = (tuple(a.cpu() for a in got[0]), tuple(a.cpu() for a in got[1]),
           got[2].cpu())
    assert assert_commit_close(got, plain(case), kind) == 0
    assert output_sha256(got) == OUTPUT_SHA256[kind]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', EDGE_KINDS)
def test_kernel_edge_cases(cuda, kind):
    case = edge_case(kind)
    got = host_commit(ac.assoc_commit_library(), case, None, cuda)
    got = (tuple(a.cpu() for a in got[0]), tuple(a.cpu() for a in got[1]),
           got[2].cpu())
    assert assert_commit_close(got, plain(case), kind) == 0
    assert output_sha256(got) == EDGE_SHA256[kind]


@pytest.mark.cuda
def test_kernel_runs_without_a_host_sync(cuda):
    case = commit_case('contested', CASE_SEEDS['contested'])
    states, hists, dets, embs, casc, history_size = (
        tuple(a.to(cuda) for a in x) if isinstance(x, tuple)
        else x.to(cuda) if isinstance(x, torch.Tensor) else x
        for x in torch_case(case))
    frame = T(FRAME).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = ttr.commit_core(KalmanConfig(), CONFIRM, MAX_AGE, history_size,
                              tuple(a[0] for a in states),
                              tuple(a[0] for a in hists),
                              *(a[0] for a in dets), embs[0], FRAME_ID,
                              frame, tuple(a[0] for a in casc))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = plain(case)
    assert assert_commit_close(
        (tuple(a[None].cpu() for a in got[0]),
         tuple(a[None].cpu() for a in got[1]), got[2][None].cpu()),
        want, 'no sync') == 0
