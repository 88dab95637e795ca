"""The point-assembly kernel of the port (``csrc/gap_points.cu``, wrapper
``ops.gap_points.gap_points``): the depth order of the tracks, corner
management and the LK point set of a gap frame, for every stream of a
call.

On the CPU the kernel's own source is built for the host with g++ through
tests/cuda_host_shim.py (its blocks in turn on a team of host threads, the
warp collectives meetings of a warp's 32, the programmatic-dependent-launch
calls no-ops as the launches run in turn, ``-ffp-contract=off`` as the
card's build runs under ``-fmad=false``; the kernel strides its loops by
the block's thread count and takes whole warps, so the tests run it with
32 or 64 threads a block; a second build keeps 8 keys a selection in shared
memory where the kernel keeps 1,024, so that the selections' passes over
the whole domain run). Each build equals the plain version
(``tracker.gap_points_core``, and ``tracker.gap_points_batch`` at two
streams) bit for bit, every output, at every flow budget from 32 to 128,
on tracks in random places (some partly outside the frame, some invalid or
too old to be active), tracks nested in depth order, a track with no free
candidate, small boxes with fewer than 32 eligible candidates (the -inf
places filled), small boxes whose keypoints are kept (no new detection),
candidate scores rounded to force ties, a track that selects with no
eligible candidate (all 32 places -inf), a track with more eligible
candidates than a selection stages, and a background block keeping 256;
and gives every output that the first design gave on each
synthetic call (``OUTPUT_SHA256``). The plain version and the host build
equal the JAX package's ``_gap_points_kernel`` on the same inputs, bit for
bit as tests/test_torch_flow.py holds ``flow_points_core``.

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the CPU test that needs it):

    python -m pytest tests/test_torch_gap_points.py -m cuda
"""
import ctypes
import hashlib

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import tracker as ttr
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.ops import gap_points as gp

from .cuda_host_shim import build_host
from .test_torch_flow_preprocess import frames_of, spec_of

F32 = np.float32
SIZE = (320, 240)
SPEC = spec_of(SIZE)
T_CAP = ttr.MAX_TRACKS
K = tfk.KP_PER_TRACK
KINDS = ('random', 'nested', 'no_free', 'few', 'keep', 'ties')
BUDGETS = (32, 48, 64, 96, 128)
BIG_SIZE = (640, 480)
FLAT_BOX = [40.0, 30.0, 100.0, 110.0]
OUTPUTS = ('all_prev', 'all_valid', 'inside', 'forder', 'f_tlbrs', 'f_valid')


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def track_state(kind, f_cap, seed=0, size=SIZE):
    """One stream's tracker state (the N_STATE fields, T_CAP slots) of the
    ``kind`` of case: f_cap + 16 tracks (at most T_CAP), a tenth of them
    invalid and a tenth too old to be active, so that the budget cuts the
    active tracks at 32 and 48 and leaves inactive rows in the flow order
    at 96 and 128. 'flat' gives track 0 a box over candidates of score 0
    (flow_state) and no valid keypoint, so it selects with no eligible
    candidate (all 32 places -inf); 'big' (at BIG_SIZE) makes track 0 the
    nearest, over most of the frame, with no valid keypoint, so that more
    candidates are eligible than a selection stages."""
    rng = np.random.default_rng(seed)
    w_f, h_f = size
    n = min(T_CAP, f_cap + 16)
    tlbrs = np.zeros((T_CAP, 4), F32)
    if kind in ('few', 'keep'):
        wh = rng.uniform(3, 14, (n, 2))
    else:
        wh = rng.uniform([12, 20], [110, 150], (n, 2))
    tl = rng.uniform([-25, -25], [w_f - 5, h_f - 5], (n, 2))
    tlbrs[:n] = np.concatenate([tl, tl + wh], 1)
    if kind == 'nested':             # each box inside the one before, nearer
        for i in range(1, n, 2):
            tlbrs[i] = tlbrs[i - 1] + [6, 6, -6, -1]
    if kind == 'no_free':            # a far box wholly inside a near one
        tlbrs[0] = [40, 30, 200, 220]
        tlbrs[1] = [60, 50, 120, 150]
    if kind == 'flat':
        tlbrs[0] = FLAT_BOX
    if kind == 'big':
        tlbrs[0] = [30, 20, w_f - 40, h_f - 10]
        tlbrs[1:n, 3] = np.minimum(tlbrs[1:n, 3], h_f - 20)
    valid = np.arange(T_CAP) < n
    valid[rng.permutation(n)[:n // 10]] = False
    ages = np.where(rng.uniform(size=T_CAP) < 0.1, 2,
                    rng.integers(0, 2, T_CAP)).astype(np.int32)
    ages[:2] = 0
    valid[:2] = True
    centre = (tlbrs[:, None, :2] + tlbrs[:, None, 2:]) / 2
    spread = (tlbrs[:, None, 2:] - tlbrs[:, None, :2]) * 0.8 + 4
    kps = (centre + rng.uniform(-0.5, 0.5, (T_CAP, K, 2)) * spread) \
        .astype(F32)
    kpv = rng.uniform(size=(T_CAP, K)) < (0.9 if kind == 'keep' else 0.6)
    if kind in ('flat', 'big'):
        kpv[0] = False
    state = [np.zeros((T_CAP, 8), F32),
             np.tile(np.eye(8, dtype=F32), (T_CAP, 1, 1)), tlbrs, valid,
             ages, np.ones(T_CAP, np.int32), np.ones(T_CAP, np.int32),
             np.zeros(T_CAP, np.int32), np.zeros(T_CAP, np.int32),
             np.zeros(T_CAP, bool), np.ones(T_CAP, F32), kps, kpv,
             np.zeros((T_CAP, 4), F32), np.zeros(T_CAP, F32)]
    return tuple(T(a) for a in state)


def flow_state(kind, seed=0, n_streams=1, spec=SPEC):
    """The flow state of a textured frame (one stream, or a stack), its
    candidate scores rounded in 'ties' so that many tie, and 0 in 'flat'
    inside FLAT_BOX."""
    pre = tfk.preprocess_reference(spec, frames_of('texture', spec.size,
                                                   n_streams, seed))
    if kind == 'ties':
        pre = pre[:3] + (torch.round(pre[3] / 500.0) * 500.0, pre[4],
                         torch.round(pre[5] / 200.0) * 200.0)
    if kind == 'flat':
        inside = tfk.in_box(pre[2], torch.tensor(FLAT_BOX))
        pre = pre[:3] + (torch.where(inside, 0.0, pre[3]),) + pre[4:]
    return pre


def case(kinds, f_cap, seed=0, size=SIZE, bg_scale=(0.1, 0.1)):
    """(spec, states, prev_states, f_cap) of a call: one stream without a
    stream axis, several stacked."""
    spec = SPEC if (size, bg_scale) == (SIZE, (0.1, 0.1)) else \
        spec_of(size, bg_scale=bg_scale)
    states = [track_state(k, f_cap, seed + s, size)
              for s, k in enumerate(kinds)]
    pres = [flow_state(k, seed + s, spec=spec) for s, k in enumerate(kinds)]
    if len(kinds) == 1:
        return spec, states[0], pres[0], f_cap
    stack = tuple(torch.stack(f) for f in zip(*states))
    pre = tuple([torch.stack(lv) for lv in zip(*(p[i] for p in pres))]
                if i < 2 else torch.stack([p[i] for p in pres])
                for i in range(6))
    return spec, stack, pre, f_cap


def assert_points_equal(got, want, tag=''):
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (tag, name)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        diff = g != w
        assert not diff.any(), (f'{tag} {name}: {int(diff.sum())} of '
                                f'{diff.numel()} differ')


# the host builds' shared-memory key stages: the kernel's own, and one of
# 8 keys, so that the selections also run their passes over the domain
STAGES = (None, 8)


@pytest.fixture(scope='module', params=STAGES,
                ids=lambda n: f'stage{n or ""}')
def host_kernel(request, tmp_path_factory):
    defines = () if request.param is None else \
        (f'-DGAP_POINTS_STAGE={request.param}',)
    lib = build_host('gap_points', tmp_path_factory, defines)
    lib.gap_points_forward.argtypes = gp.FORWARD_ARGTYPES
    lib.gap_points_forward.restype = ctypes.c_int
    return lib


def host_run(lib, args, threads=32):
    """One call of the host-built kernel on CPU tensors, as ``gap_points``
    returns it."""
    lib.set_host_threads(threads)
    outputs, launch = gp.gap_points_launch_args(*args)
    assert lib.gap_points_forward(*launch) == 0
    return outputs


def test_cases_are_what_they_say():
    """Each case exercises its path in the plain version: new keypoints
    with -inf places ('few'), kept keypoints ('keep'), a track with no
    free candidate ('no_free'), ties among the chosen scores ('ties')."""
    for kind in KINDS:
        spec, st, pre, f_cap = case([kind], 48)
        all_prev, all_valid, inside, forder, f_tlbrs, f_valid = \
            ttr.gap_points_core(spec, st, pre, f_cap)
        kpv = all_valid[:f_cap * K].reshape(f_cap, K)
        assert f_valid.sum() > 20, kind
        if kind == 'few':                  # valid tracks short of 32 points
            n = kpv[f_valid].sum(1)
            assert ((n > 0) & (n < K)).sum() > 5
        if kind == 'keep':                 # propagated keypoints kept
            kept = (all_prev[:f_cap * K].reshape(f_cap, K, 2)
                    == st[11][forder]).all(-1).all(-1) & f_valid
            assert kept.sum() > 5
        if kind == 'no_free':           # track 1 under the nearer track 0
            pos = [forder.tolist().index(i) for i in (0, 1)]
            assert pos[0] < pos[1] and bool(f_valid[pos[1]])
            assert not kpv[pos[1]].any() and kpv[pos[0]].sum() > 10
        if kind == 'ties':
            score = pre[3]
            assert len(torch.unique(score)) < score.numel() // 4
    # the budget cuts the active tracks, or leaves inactive rows
    for f_cap, more in ((32, True), (48, True), (96, False), (128, False)):
        _, st, _, _ = case(['random'], f_cap, seed=f_cap)
        assert (int((st[3] & (st[4] < 2)).sum()) > f_cap) == more


@pytest.mark.parametrize('f_cap', BUDGETS)
@pytest.mark.parametrize('kind', KINDS)
def test_host_kernel_equals_plain_version(host_kernel, kind, f_cap):
    args = case([kind], f_cap, seed=f_cap)
    assert_points_equal(host_run(host_kernel, args),
                        gp.gap_points_reference(*args), f'{kind} {f_cap}')


@pytest.mark.parametrize('threads', [32, 64])
def test_host_kernel_two_streams(host_kernel, threads):
    """Two streams in one call: ``gap_points_batch``'s outputs, and each
    stream what it gets alone."""
    args = case(['nested', 'ties'], 64, seed=3)
    got = host_run(host_kernel, args, threads)
    assert_points_equal(got, gp.gap_points_reference(*args))
    spec, st, pre, f_cap = args
    for s in range(2):
        one = (spec, tuple(a[s] for a in st),
               tuple([lv[s] for lv in p] if i < 2 else p[s]
                     for i, p in enumerate(pre)), f_cap)
        alone = host_run(host_kernel, one, threads)
        assert all(torch.equal(g[s], a) for g, a in zip(got, alone))


# Each synthetic call's outputs as the first design of the kernel (the
# select launch after the owner launch, 4-bit radix passes) gave them:
# (kinds, flow budget, seed, frame size, bg scale) -> the sha256 of the six
# outputs' bytes in order
OUTPUT_SHA256 = {
    (('random',), 48, 5, SIZE, 0.1):
        '1e594628b8cfb35c4c0d8044edb7a910c8bb4ab70f1ca6965a92fcdb6d6b423d',
    (('nested', 'ties', 'few'), 128, 5, SIZE, 0.1):
        'ec6cc070cc5a719efc3a8f1ae218ac916da6f83d316e4e5bd6c2ea89abdeef94',
    (('keep', 'no_free'), 32, 5, SIZE, 0.1):
        '61ef7fc226567fa93428ee83a103409af68f21b4da43225902865e21f37b6873',
    (('flat',), 64, 7, SIZE, 0.1):
        'ff987e7f767d31bfc349b970d903e7d4d0d3d40817a22cf7c77cd5e458b2dc0e',
    (('big',), 32, 3, BIG_SIZE, 0.1):
        'aef8eb20fd1e96db962531a771eb117a953c690c0b01a4bbbce8520d4beb3db4',
    (('random', 'ties'), 96, 2, SIZE, 0.5):
        'e250bc1c3a7a6ea09ef75549fe7666f5ba1273b463b3b9eb79f1ef1fd4fb7e30',
    (('few', 'flat'), 48, 11, SIZE, 0.5):
        '65b0df23405fed2b264563156093534a0924d5b437f39454f97a4110394e79e5',
}


def hash_case(key):
    """gap_points' arguments of an OUTPUT_SHA256 call."""
    kinds, f_cap, seed, size, bg = key
    return case(list(kinds), f_cap, seed, size, (bg, bg))


def hash_case_id(key):
    kinds, f_cap, _, size, bg = key
    return f'{"-".join(kinds)}-{f_cap}-{size[0]}x{size[1]}-bg{bg}'


def output_sha256(outputs):
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize('key', OUTPUT_SHA256, ids=hash_case_id)
def test_host_kernel_outputs_equal_the_first_design(host_kernel, key):
    """Every output of the host build, to the bit, is what the first design
    gave on the same call (``OUTPUT_SHA256``)."""
    args = hash_case(key)
    assert output_sha256(host_run(host_kernel, args)) == OUTPUT_SHA256[key]


def eligible(spec, st, pre, i):
    """How many candidates track i could select if it selected: owned by
    no nearer track, inside the ellipse of its box, at least quality_level
    times its best owned score (one stream, the plain version's tests)."""
    pts, score = pre[2], pre[3]
    w, h = spec.size
    active = st[3] & (st[4] < 2)
    key = torch.where(active, -st[2][:, 3] + st[4].float() * 1e-3,
                      torch.full_like(st[2][:, 3], float('inf')))
    order = torch.argsort(key, stable=True).tolist()
    frame = torch.tensor([0.0, 0.0, w - 1.0, h - 1.0])
    clip = torch.cat([torch.maximum(st[2][:, :2], frame[:2]),
                      torch.minimum(st[2][:, 2:], frame[2:])], 1)
    owned = tfk.in_box(pts, clip[i])
    for j in order[:order.index(i)]:
        if active[j]:
            owned &= ~tfk.in_box(pts, clip[j])
    box = st[2][i]
    c, semi = (box[:2] + box[2:]) / 2, ((box[2:] - box[:2]) + 1) / 2
    ell = (((pts - c) / semi) ** 2).sum(-1) <= 1
    best = score[owned].max() if owned.any() else torch.tensor(0.0)
    return int((owned & ell & (score >= spec.quality_level
                               * torch.clamp(best, min=1e-6))).sum()), \
        int(owned.sum())


@pytest.mark.parametrize('kind,f_cap,size,bg', [
    ('flat', 64, SIZE, 0.1), ('big', 32, BIG_SIZE, 0.1),
    ('ties', 32, SIZE, 0.5)], ids=['all_inf', 'past_the_stage', 'bg_256'])
def test_host_kernel_edge_cases(host_kernel, kind, f_cap, size, bg):
    """The selections' edges, each what it says, bit for bit: a track that
    selects with no eligible candidate (every place -inf); a track with
    more eligible candidates than a selection stages (1,024); the
    background block keeping 256 of more than 256 bg candidates."""
    args = case([kind], f_cap, 4, size, (bg, bg))
    spec, st, pre, _ = args
    want = gp.gap_points_reference(*args)
    if kind == 'flat':
        n_elig, n_owned = eligible(spec, st, pre, 0)
        pos = want[3].tolist().index(0)
        assert n_elig == 0 and n_owned > 0 and bool(want[5][pos])
        assert not want[1][pos * K:(pos + 1) * K].any()
    if kind == 'big':
        assert eligible(spec, st, pre, 0)[0] > 1024
    if kind == 'ties':
        assert pre[5].numel() > tfk.BG_KP and \
            int(want[1][f_cap * K:].sum()) == tfk.BG_KP
    assert_points_equal(host_run(host_kernel, args, 64), want, kind)


@pytest.mark.parametrize('kind,f_cap', [('random', 32), ('ties', 128),
                                        ('nested', 48)])
def test_plain_and_host_match_jax(host_kernel, kind, f_cap):
    """The plain version and the host build against the JAX package's
    ``_gap_points_kernel`` on the same state and candidates, every output
    equal."""
    from fastmot_tpu import tracker as jtr
    from fastmot_tpu.ops import flow_kernels as jfk
    jspec = jfk.FlowSpec(size=SIZE, opt_scale=(0.5, 0.5),
                         bg_scale=(0.1, 0.1))
    args = case([kind], f_cap, seed=9)
    spec, st, pre, _ = args
    want = jtr._gap_points_kernel(
        jspec, tuple(a.numpy() for a in st),
        (None, None) + tuple(a.numpy() for a in pre[2:]), f_cap=f_cap)
    want = tuple(torch.from_numpy(np.array(w)) for w in want)
    plain = gp.gap_points_reference(*args)
    host = host_run(host_kernel, args)
    for got in (plain, host):
        for name, g, w in zip(OUTPUTS, got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy().astype(
                g.numpy().dtype), err_msg=name)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version():
    args = case(['random'], 48)
    assert_points_equal(gp.gap_points(*args),
                        ttr.gap_points_core(*args))
    args = case(['few', 'keep'], 32)
    assert_points_equal(gp.gap_points(*args), tuple(
        t.contiguous() for t in ttr.gap_points_batch(
            args[0], args[3], args[1], args[2])))


def test_wrapper_raises_on_other_devices():
    spec, st, pre, f_cap = case(['random'], 32)
    meta = tuple(a.to('meta') for a in st)
    with pytest.raises(ValueError, match='unsupported device'):
        gp.gap_points(spec, meta, pre, f_cap)


def _faulty(args, fault):
    spec, st, pre, f_cap = args
    st, pre = list(st), list(pre)
    if fault == 'dtype':
        st[4] = st[4].long()
    elif fault == 'shape':
        st[11] = st[11][:, :16]
    elif fault == 'contiguous':
        st[2] = torch.cat([st[2], st[2]], -1)[:, ::2]
    elif fault == 'device':
        pre[3] = pre[3].to('meta')
    elif fault == 'budget':
        f_cap = 129
    elif fault == 'candidates':
        pre[2], pre[3] = pre[2][:-8], pre[3][:-8]
    elif fault == 'state_fields':
        st = st[:14]
    elif fault == 'streams':
        st[3] = st[3][None]
    return spec, tuple(st), tuple(pre), f_cap


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'contiguous', 'device',
                                   'budget', 'candidates', 'state_fields',
                                   'streams'])
def test_launch_args_raise_on_each_fault(fault):
    args = case(['random'], 32)
    gp.gap_points_launch_args(*args)       # the unbroken call passes
    with pytest.raises(ValueError, match='gap_points: '):
        gp.gap_points_launch_args(*_faulty(args, fault))


def test_main_path_arguments_pass_the_kernel_checks(monkeypatch):
    """``MultiTracker.track`` and ``StreamTracker.track`` on the CPU hand
    the wrapper arguments its kernel takes (every call checked), one call
    a tracked frame for all of a call's streams."""
    from fastmot_tpu_torch.detector import make_detections
    from fastmot_tpu_torch.parallel import StreamTracker
    calls = []
    real = gp.gap_points

    def checked(*args):
        gp.gap_points_launch_args(*args)
        calls.append(args[1][2].shape[0] if args[1][2].dim() == 3 else 1)
        return real(*args)
    monkeypatch.setattr(gp, 'gap_points', checked)
    frames = [frames_of('texture', SIZE, 1, s).numpy() for s in range(3)]
    boxes = np.array([[30, 40, 80, 150], [150, 50, 205, 170]], float)
    dets = make_detections(boxes, np.ones(2, int), np.full(2, 0.9))
    trk = ttr.MultiTracker(SIZE, 'euclidean', device='cpu')
    trk.reset(1 / 30.0)
    trk.init(torch.from_numpy(frames[0]), dets)
    for i in (1, 2):
        trk.track(torch.from_numpy(frames[i]), i)
    st = StreamTracker(SIZE, 'euclidean', 2, device='cpu')
    st.reset(1 / 30.0)
    st.init(np.stack([frames[0], frames[1]]), [dets, dets])
    for i in (1, 2):
        st.track(np.stack([frames[i], frames[0]]), i)
    assert calls == [1, 1, 2, 2]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _to(args, device):
    spec, st, pre, f_cap = args
    return (spec, tuple(a.to(device) for a in st),
            tuple([lv.to(device) for lv in p] if i < 2 else p.to(device)
                  for i, p in enumerate(pre)), f_cap)


@pytest.mark.cuda
@pytest.mark.parametrize('kinds,f_cap', [(('random',), 48),
                                         (('nested', 'ties', 'few'), 128),
                                         (('keep', 'no_free'), 32)])
def test_kernel_matches_plain_version(cuda, kinds, f_cap):
    """The kernel on the card against the plain version run on the CPU, bit
    for bit, and one call a call."""
    args = case(list(kinds), f_cap, seed=5)
    before = gp.gap_points.launches
    got = gp.gap_points(*_to(args, cuda))
    torch.cuda.synchronize()
    assert gp.gap_points.launches == before + 1
    assert_points_equal(tuple(g.cpu() for g in got),
                        gp.gap_points_reference(*args))


@pytest.mark.cuda
def test_kernel_is_repeatable_and_raises_on_bad_arguments(cuda):
    args = _to(case(['random', 'ties'], 96), cuda)
    a, b = gp.gap_points(*args), gp.gap_points(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match='gap_points: '):
        gp.gap_points(*_faulty(args, 'dtype'))
