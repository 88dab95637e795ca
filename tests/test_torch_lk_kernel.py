"""The pyramidal-LK kernel of the port (``csrc/lk_pyramidal.cu``, wrapper
``ops.flow_kernels.lk_pyramidal``).

On the CPU: a per-point sequential reference in numpy, written in the
kernel's loop order (one point at a time, every level, its own step loop),
equals the port's lockstep plain version ``lk_pyramidal_reference`` bit for
bit and agrees with the JAX package's ``lk_pyramidal``, on 80x60 frames
with 3 levels and points that never converge, sit on a flat window the
gate rejects, are invalid or lie on the border; the wrapper on CPU tensors
is the plain version (with either kernel forced, or the pick of
``lk_design``, whose threshold is checked); the argument checks raise on
what the kernel does not take; the main path's LK arguments pass them; and
the kernel's own source, built for the host with g++ through a shim of the
few CUDA names it uses (a warp's lanes as host threads, the tile shuffles
as meetings), equals the plain version bit for bit: the tile kernel and
the one-thread kernel, also on warps whose tiles take 0, 1 and 10 steps
and blocks that straddle two streams. The bit-for-bit checks
rest on the order in which ATen's CPU sum adds a row's 25 terms, which
``aten_sum_lanes`` reads off this host and its failures name (with
``torch.backends.cpu.get_cpu_capability()``): the kernel sums in the
8-lane order of ATen's x86 builds, AVX-512 hosts included.

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the one test that needs it, so this file runs where there is no
JAX): the wrapper's pick bit-equal to the plain version run on the CPU,
the two kernels bit-equal to each other at the main path's shapes, the
wrapper launching ``lk_design``'s pick there, repeatability, and one
launch of the pick (none of the other) per ``lk_core`` call:

    python -m pytest tests/test_torch_lk_kernel.py -m cuda
"""
import functools

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from fastmot_tpu_torch.ops import flow_kernels as tfk

F32 = np.float32
SPEC_ARGS = dict(size=(80, 60), opt_scale=(1.0, 1.0), bg_scale=(0.1, 0.1),
                 max_level=2)
TSPEC = tfk.FlowSpec(**SPEC_ARGS)
SHIFT = (2, 1)                     # the scene moves by (-2, -1)
FLAT = (slice(20, 42), slice(4, 24))       # rows, cols: constant in prev
NOISE = (slice(4, 22), slice(48, 72))      # fresh noise in cur
FLAT_PT = (13.0, 31.0)
NOISE_PTS = [(58.0, 11.0), (61.5, 13.25), (55.0, 16.0), (64.0, 9.0)]
BORDER_PTS = [(0.0, 0.0), (79.0, 59.0), (-2.0, 30.0), (84.5, 10.0),
              (40.0, -1.5), (40.0, 59.4), (0.3, 58.7), (78.9, 0.2)]
# port against JAX (tests/test_torch_flow.py::test_lk_matches_jax): a
# pyramid value a float32 ulp from .5 can round to another uint8, and the
# JAX loop sums in another order, which moves a point by a few hundredths
# of a pixel
STATUS_SHARE, CLOSE_SHARE, CLOSE_PX, MAX_PX = 0.99, 0.9, 1e-3, 0.1


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bit_equal(got, want):
    """(new_pts, status, err) equal bit for bit."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def lk_frames(seed=0, h=60, w=80, pad=8):
    """(prev, cur) BGR uint8: a smooth texture moved by SHIFT, with a flat
    block in prev and a block of fresh noise in cur."""
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(
        rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad)).astype(F32), 1.5)
    base = (base - base.mean()) * 3 + 128
    dx, dy = SHIFT
    prev = base[pad:pad + h, pad:pad + w].copy()
    cur = base[pad + dy:pad + dy + h, pad + dx:pad + dx + w].copy()
    prev[FLAT] = 128.0
    cur[NOISE] = rng.uniform(0, 255, cur[NOISE].shape)
    return [np.repeat(np.clip(f, 0, 255).astype(np.uint8)[..., None], 3, -1)
            for f in (prev, cur)]


def lk_points(seed=1, n=300):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, 79, n), rng.uniform(0, 59, n)], -1)
    special = [FLAT_PT] + NOISE_PTS + BORDER_PTS
    pts = np.concatenate([np.array(special), pts]).astype(F32)
    valid = rng.uniform(size=len(pts)) < 0.9
    valid[:len(special)] = True
    valid[len(special):len(special) + 3] = False
    return pts, valid


# ---------------------------------------------------------------------------
# The per-point reference, in numpy, in the kernel's loop order
# ---------------------------------------------------------------------------

# the lanes of the sum order csrc/lk_pyramidal.cu implements (row_sum)
KERNEL_SUM_LANES = 8


def torch_order_sum(x, lanes=KERNEL_SUM_LANES):
    """Sum of a float32 row in the order of PyTorch's CPU sum over a
    contiguous row, as the kernel takes it at 8 lanes: ``lanes``-wide
    vectors into four accumulators, folded into the first, then the
    scalar tail followed by the lanes."""
    n = x.size
    n_vec = n // lanes
    groups = n_vec // 4
    acc = np.zeros((4, lanes), F32)
    for i in range(groups):
        for g in range(4):
            acc[g] += x[(4 * i + g) * lanes:(4 * i + g + 1) * lanes]
    for j in range(4 * groups, n_vec):
        acc[0] += x[j * lanes:(j + 1) * lanes]
    for g in range(1, 4):
        acc[0] += acc[g]
    s = F32(0)
    for t in range(n_vec * lanes, n):
        s = F32(s + x[t])
    for k in range(lanes):
        s = F32(s + acc[0, k])
    return s


@functools.cache
def aten_sum_lanes():
    """The vector width in which ATen's CPU sum adds a contiguous float32
    row on this host, read off rows of 25 terms (the LK window's sums)
    whose sum depends on the order; fails naming the host's CPU
    capability if it is none of 4, 8 and 16 lanes."""
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((64, 25))
            * 10.0 ** rng.uniform(-4, 4, (64, 25))).astype(F32)
    sums = torch.from_numpy(rows).sum(-1).numpy()
    for lanes in (4, 8, 16):
        if all(torch_order_sum(r, lanes) == s for r, s in zip(rows, sums)):
            return lanes
    pytest.fail('ATen sums float32 rows in no known order on this host '
                f'(torch {torch.__version__}, CPU capability '
                f'{torch.backends.cpu.get_cpu_capability()})')


def test_aten_sums_rows_in_the_kernels_order():
    """The kernel is bit-equal to the plain version on the CPU only where
    ATen sums a row in the kernel's order: 8 lanes on x86, where sum_stub
    has no AVX-512 kernel and AVX-512 hosts run the AVX2 one. Elsewhere
    the kernel holds only the LK tolerance against the plain version."""
    lanes = aten_sum_lanes()
    assert lanes == KERNEL_SUM_LANES, (
        f'ATen sums rows in {lanes} lanes on this host (torch '
        f'{torch.__version__}, CPU capability '
        f'{torch.backends.cpu.get_cpu_capability()}), the kernel in '
        f'{KERNEL_SUM_LANES}: the kernel is not bit-equal to the plain '
        'version here')


def sample_halo_np(img, x, y, win):
    """_sample_halo for one point: the (win+2)^2 bilinear halo."""
    h, w = img.shape
    x = np.clip(F32(x), F32(0), F32(w - 1.001))
    y = np.clip(F32(y), F32(0), F32(h - 1.001))
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = F32(x - x0), F32(y - y0)
    half = (win - 1) // 2
    offs = np.arange(win + 3) - half - 1
    ys = np.clip(int(y0) + offs, 0, h - 1)
    xs = np.clip(int(x0) + offs, 0, w - 1)
    r = img[ys][:, xs]
    n = win + 2
    one = F32(1)
    return ((one - fy) * (one - fx) * r[:n, :n] + (one - fy) * fx * r[:n, 1:]
            + fy * (one - fx) * r[1:, :n] + fy * fx * r[1:, 1:])


def lk_point_by_point(prev, cur, pts, valid, spec, lanes):
    """The kernel's loop for each point in turn (levels [h, w] float32,
    finest first), its sums in ``lanes``-wide order. Returns (new_pts,
    status, err, steps [P, L], gate [P, L]) with the levels of steps and
    gate finest first."""
    wi = spec.win
    ww = wi * wi
    n_levels = len(prev)

    def row_sum(x):
        return torch_order_sum(x, lanes)

    eps2 = F32(0.03 * 0.03)
    out_pts = np.zeros_like(pts)
    status = np.zeros(len(pts), bool)
    errs = np.zeros(len(pts), F32)
    steps_all = np.zeros((len(pts), n_levels), np.int32)
    gate_all = np.zeros((len(pts), n_levels), bool)
    for i, (pt, is_valid) in enumerate(zip(pts, valid)):
        v = np.zeros(2, F32)
        err = F32(0)
        ok = bool(is_valid)
        for lvl in range(n_levels - 1, -1, -1):
            if is_valid:
                p = pt * F32(2.0 ** -lvl)
                t = sample_halo_np(prev[lvl], p[0], p[1], wi)
                tp = t[1:wi + 1, 1:wi + 1].reshape(ww)
                gx = (F32(0.5) * (t[1:wi + 1, 2:wi + 2] - t[1:wi + 1, 0:wi])
                      ).reshape(ww)
                gy = (F32(0.5) * (t[2:wi + 2, 1:wi + 1] - t[0:wi, 1:wi + 1])
                      ).reshape(ww)
                gxx = row_sum(gx * gx)
                gyy = row_sum(gy * gy)
                gxy = row_sum(gx * gy)
                det = F32(gxx * gyy - gxy * gxy)
                d = F32(gxx - gyy)
                q = max(F32(d * d + F32(4.0) * F32(gxy * gxy)), F32(0))
                min_eig = F32(F32(0.5) * F32(F32(gxx + gyy) - np.sqrt(q)))
                gate = F32(min_eig / F32(ww)) > F32(1e-4)
                det_safe = det if det > F32(1e-12) else F32(1)
                active = spec.iters > 0
                steps = 0
                while active:
                    c = sample_halo_np(cur[lvl], F32(p[0] + v[0]),
                                       F32(p[1] + v[1]), wi)
                    diff = tp - c[1:wi + 1, 1:wi + 1].reshape(ww)
                    e = F32(row_sum(np.abs(diff)) / F32(ww))
                    bx = row_sum(diff * gx)
                    by = row_sum(diff * gy)
                    dx = F32(F32(gyy * bx) - F32(gxy * by)) / det_safe
                    dy = F32(F32(gxx * by) - F32(gxy * bx)) / det_safe
                    step = np.clip(np.array([dx, dy], F32), F32(-wi),
                                   F32(wi))
                    err = e
                    if gate:
                        v = v + step
                    steps += 1
                    active = bool(gate and F32(step[0] * step[0]
                                               + step[1] * step[1]) >= eps2
                                  and steps < spec.iters)
                ok = ok and bool(gate)
                steps_all[i, lvl], gate_all[i, lvl] = steps, gate
            if lvl > 0:
                v = v * F32(2)
        new = pt + v
        h0, w0 = cur[0].shape
        out_pts[i] = new
        status[i] = ok and 0 <= new[0] <= w0 - 1 and 0 <= new[1] <= h0 - 1
        errs[i] = err
    return out_pts, status, errs, steps_all, gate_all


@pytest.fixture(scope='module')
def lk_case():
    """The frames' port pyramids, the points and the per-point result,
    its sums in the order of this host's ATen."""
    frames = lk_frames()
    prev, cur = (tfk.preprocess(TSPEC, T(f))[1] for f in frames)
    pts, valid = lk_points()
    ref = lk_point_by_point([p.numpy() for p in prev],
                            [c.numpy() for c in cur], pts, valid, TSPEC,
                            aten_sum_lanes())
    return frames, prev, cur, pts, valid, ref


def test_lk_case_has_every_kind_of_point(lk_case):
    """The inputs hold what the comparisons must cover: a point that never
    converges (its step cap ends a level), a flat window the gate rejects,
    invalid points, border points in and out of the image, and points
    that track the motion."""
    _, _, _, pts, valid, (new, status, err, steps, gate) = lk_case
    n_noise = len(NOISE_PTS)
    capped = valid & gate.all(1) & (steps == TSPEC.iters).any(1)
    assert capped[1:1 + n_noise].any(), steps[1:1 + n_noise]
    assert not gate[0, 0] and not status[0] and steps[0, 0] == 1
    assert (~valid).sum() >= 3
    assert np.all(steps[~valid] == 0) and np.all(err[~valid] == 0)
    assert np.array_equal(new[~valid], pts[~valid])
    assert not status[~valid].any()
    border = slice(1 + n_noise, 1 + n_noise + len(BORDER_PTS))
    assert status[border].any() and not status[border].all()
    moved = status & gate.all(1)
    np.testing.assert_allclose(np.median(new[moved] - pts[moved], 0),
                               [-SHIFT[0], -SHIFT[1]], atol=0.1)


def test_point_by_point_equals_lockstep_plain_version(lk_case):
    """The kernel's per-point loop gives every point, bit for bit, what the
    lockstep loop gives it, with the same number of steps at each level
    (its sums in the order of this host's ATen, as the plain version's)."""
    _, prev, cur, pts, valid, (new, status, err, steps, _) = lk_case
    trace = []
    got = tfk.lk_pyramidal_reference(prev, cur, T(pts), T(valid), TSPEC,
                                     trace)
    assert [lvl for lvl, _, _ in trace] == [2, 1, 0]
    for lvl, _, trips in trace:
        np.testing.assert_array_equal(
            sum(a.numpy().astype(np.int32) for _, a in trips), steps[:, lvl])
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  new.view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), status)
    np.testing.assert_array_equal(got[2].numpy().view(np.int32),
                                  err.view(np.int32))


def test_point_by_point_agrees_with_jax(lk_case):
    """Against the JAX package's lk_pyramidal, jitted on the CPU as
    tests/test_flow.py runs it, on its own preprocess of the same frames."""
    jax = pytest.importorskip('jax')
    from fastmot_tpu.ops import flow_kernels as jfk
    frames, _, _, pts, valid, (new, status, _, _, _) = lk_case
    jspec = jfk.FlowSpec(**SPEC_ARGS)
    js = [jfk.preprocess(jspec, f) for f in frames]
    want, want_ok, _ = jax.jit(jfk.lk_pyramidal, static_argnames='spec')(
        js[0][0], js[0][1], js[1][0], js[1][1], pts, valid, jspec)
    want, want_ok = np.asarray(want), np.asarray(want_ok)
    assert (status == want_ok).mean() > STATUS_SHARE
    both = status & want_ok
    assert both.sum() > 200
    diff = np.abs(new[both] - want[both]).max(1)
    assert (diff < CLOSE_PX).mean() > CLOSE_SHARE, np.sort(diff)[-20:]
    assert diff.max() < MAX_PX, diff.max()


@pytest.mark.parametrize('streams', [False, True], ids=['2d', 'streams'])
def test_wrapper_on_cpu_is_the_plain_version(lk_case, streams):
    _, prev, cur, pts, valid, _ = lk_case
    args = (prev, cur, T(pts), T(valid))
    if streams:        # two streams whose frames differ
        args = ([torch.stack([a, b.flip(-1)]) for a, b in zip(prev, prev)],
                [torch.stack([a, b.flip(-1)]) for a, b in zip(cur, cur)],
                torch.stack([T(pts), T(pts[::-1].copy())]),
                torch.stack([T(valid), T(valid[::-1].copy())]))
    before = dict(tfk.lk_pyramidal.launches)
    got = tfk.lk_pyramidal(*args, TSPEC)
    want = tfk.lk_pyramidal_reference(*args, TSPEC)
    assert tfk.lk_pyramidal.launches == before
    assert_bit_equal(got, want)


# (points of a call, the card's SMs, the kernel lk_design picks): the
# main path's 1 x 1,792 and phase 13's 8 x 4,352 on an H100's 132 SMs,
# 2 and 3 of its streams (the tile kernel is the faster at 8,704 points,
# one thread a point at 13,056), and both sides of the threshold at 132
# and at 14 SMs
K = tfk.LK_PER_THREAD_POINTS_PER_SM
LK_PICKS = [(1792, 132, 'tile'), (8 * 4352, 132, 'per_thread'),
            (2 * 4352, 132, 'tile'), (3 * 4352, 132, 'per_thread'),
            (K * 132 - 1, 132, 'tile'), (K * 132, 132, 'per_thread'),
            (K * 14 - 1, 14, 'tile'), (K * 14, 14, 'per_thread'),
            (0, 132, 'tile')]


@pytest.mark.parametrize('n_points,n_sms,want', LK_PICKS)
def test_lk_design_picks_one_thread_from_its_threshold_on(n_points, n_sms,
                                                         want):
    assert tfk.lk_design(n_points, n_sms) == want


def _kernel_args(n_streams=2):
    gen = torch.Generator().manual_seed(0)
    dims = [(60, 80), (30, 40), (15, 20)]
    prev = [torch.rand(n_streams, h, w, generator=gen) for h, w in dims]
    cur = [torch.rand(n_streams, h, w, generator=gen) for h, w in dims]
    pts = torch.rand(n_streams, 50, 2, generator=gen) * 50
    valid = torch.ones(n_streams, 50, dtype=torch.bool)
    return prev, cur, pts, valid


def test_level_table():
    prev, cur, pts, valid = _kernel_args(3)
    table = tfk.lk_level_table(prev, cur, pts, valid, TSPEC)
    assert (table.streams, table.points) == (3, 50)
    assert table.dims == ((60, 80), (30, 40), (15, 20))
    assert table.strides == (4800, 1200, 300)


def _noncontiguous(t):
    return t.transpose(1, 2).contiguous().transpose(1, 2)


FAULTS = {
    'pts float64': (lambda a: a.update(pts=a['pts'].double()), 'pts'),
    'pts [S, P, 3]': (lambda a: a.update(pts=torch.zeros(2, 50, 3)), 'pts'),
    'valid uint8': (lambda a: a.update(valid=a['valid'].to(torch.uint8)),
                    'bool'),
    'level float64': (lambda a: a['prev'].__setitem__(
        1, a['prev'][1].double()), 'float32'),
    'non-contiguous level': (lambda a: a['cur'].__setitem__(
        0, _noncontiguous(a['cur'][0])), 'contiguous'),
    'non-contiguous pts': (lambda a: a.update(
        pts=a['pts'].transpose(0, 1).contiguous().transpose(0, 1)),
        'contiguous'),
    'one level too many': (lambda a: a['prev'].append(a['prev'][-1]),
                           'max_level'),
    'one level too few': (lambda a: (a['prev'].pop(), a['cur'].pop()),
                          'max_level'),
    'valid of 3 streams': (lambda a: a.update(
        valid=torch.ones(3, 50, dtype=torch.bool)), 'stream'),
    'level of 3 streams': (lambda a: a['prev'].__setitem__(
        2, torch.zeros(3, 15, 20)), 'stream'),
    'previous and current levels differ': (lambda a: a['cur'].__setitem__(
        2, torch.zeros(2, 14, 20)), 'level 2'),
    'level on another device': (lambda a: a['cur'].__setitem__(
        1, a['cur'][1].to('meta')), 'meta'),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_argument_checks_raise(fault):
    prev, cur, pts, valid = _kernel_args()
    a = dict(prev=list(prev), cur=list(cur), pts=pts, valid=valid)
    change, words = FAULTS[fault]
    change(a)
    with pytest.raises(ValueError, match=words):
        tfk.lk_level_table(a['prev'], a['cur'], a['pts'], a['valid'], TSPEC)


def test_argument_checks_raise_on_a_window_the_kernel_lacks():
    prev, cur, pts, valid = _kernel_args()
    for win in (3, 4, 7):
        spec = tfk.FlowSpec(**dict(SPEC_ARGS, win=win))
        with pytest.raises(ValueError, match=f'window {win}'):
            tfk.lk_level_table(prev, cur, pts, valid, spec)


def test_wrapper_raises_on_a_device_neither_cpu_nor_cuda():
    prev, cur, pts, valid = (x if isinstance(x, torch.Tensor) else
                             [t.to('meta') for t in x]
                             for x in _kernel_args())
    before = dict(tfk.lk_pyramidal.launches)
    with pytest.raises(ValueError, match='unsupported device meta'):
        tfk.lk_pyramidal(prev, cur, pts.to('meta'), valid.to('meta'), TSPEC)
    assert tfk.lk_pyramidal.launches == before


def test_main_path_lk_arguments_pass_the_kernel_checks(monkeypatch):
    """Every LK call of the gap paths (``MultiTracker.track``,
    ``StreamTracker.track`` over vmapped points, the legacy
    ``compute_flow``) hands the wrapper what the kernel takes."""
    from fastmot_tpu_torch import MultiTracker
    from fastmot_tpu_torch.detector import make_detections
    from fastmot_tpu_torch.parallel import StreamTracker
    calls = []
    reference = tfk.lk_pyramidal_reference

    def checked(prev, cur, pts, valid, spec):
        lead = (lambda x: x) if pts.dim() == 3 else (lambda x: x[None])
        calls.append(tfk.lk_level_table([lead(p) for p in prev],
                                        [lead(c) for c in cur], lead(pts),
                                        lead(valid), spec))
        return reference(prev, cur, pts, valid, spec)

    monkeypatch.setattr(tfk, 'lk_pyramidal', checked)
    size, n_obj = (160, 120), 2
    frames = [lk_frames(seed=s, h=120, w=160) for s in (0, 1)]
    dets = make_detections(np.array([[20, 20, 60, 100], [90, 10, 140, 90]],
                                    float), np.ones(n_obj, int),
                           np.full(n_obj, 0.9))
    trk = MultiTracker(size, 'euclidean', device='cpu')
    trk.reset(1 / 30.0)
    trk.init(T(frames[0][0]), dets)
    trk.track(T(frames[0][1]), 1)
    trk.compute_flow(T(frames[0][0]))
    st = StreamTracker(size, 'euclidean', 2, device='cpu')
    st.reset(1 / 30.0)
    st.init(np.stack([f[0] for f in frames]), [dets, dets])
    st.track(np.stack([f[1] for f in frames]), 1)
    assert [c.streams for c in calls] == [1, 1, 2]
    # the flow works at half scale, over 6 levels
    assert all(c.dims == ((60, 80), (30, 40), (15, 20), (7, 10), (3, 5),
                          (1, 2)) for c in calls), [c.dims for c in calls]


# ---------------------------------------------------------------------------
# The kernel's own source, built for the host
# ---------------------------------------------------------------------------

# Just enough of CUDA for csrc/lk_pyramidal.cu to build with g++: the
# rounded intrinsics are plain float operations (-ffp-contract=off: no
# FMA), and the launch runs each warp of each block in turn, its lanes as
# host threads (so a static array serves as the block's shared memory).
# __shfl_sync meets the other lanes of its mask: each writes its value
# into the meeting's slots, all wait, each reads its source's, and the
# next shuffle writes the other set of slots (a lane writes a set again
# only after every lane has passed the next meeting, so after every read
# of the last); __syncwarp is a meeting. A mask that is neither the whole
# warp nor an aligned segment aborts, and so does a meeting that some
# lane never joins.
HOST_SHIM = r"""
#pragma once
#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
using std::max;
using std::min;
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a) : x(a), y(1), z(1) {} };
struct uint3 { unsigned x, y, z; };
static thread_local uint3 blockIdx, threadIdx;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

struct Segment {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, waiting = 0, generation = 0;
  float slot[2][32];
  void meet() {
    std::unique_lock<std::mutex> lock(m);
    const int g = generation;
    if (++waiting == n) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else if (!cv.wait_for(lock, std::chrono::seconds(30),
                            [&] { return generation != g; })) {
      std::abort();
    }
  }
};
struct Warp {   // segments of 2^p lanes: seg[p][lane >> p]
  std::vector<std::unique_ptr<Segment>> seg[6];
  Warp() {
    for (int p = 0; p < 6; ++p)
      for (int k = 0; k < (32 >> p); ++k) {
        seg[p].emplace_back(new Segment);
        seg[p].back()->n = 1 << p;
      }
  }
};
static thread_local Warp* warp;
static thread_local int flip[6];

// The segment that meets for `mask`: the whole warp, or the lane's
// aligned segment of popcount(mask) lanes; anything else aborts. Sets p
// (its size is 2^p) and its first lane.
inline Segment& meeting(unsigned mask, int& p, unsigned& first) {
  const unsigned lane = threadIdx.x % 32;
  const int n = __builtin_popcount(mask);
  first = lane / n * n;
  if ((n & (n - 1)) || mask != (n == 32 ? ~0u : (1u << n) - 1u) << first)
    std::abort();
  p = __builtin_ctz(static_cast<unsigned>(n));
  return *warp->seg[p][lane >> p];
}

inline void __syncwarp(unsigned mask) {
  int p;
  unsigned first;
  meeting(mask, p, first).meet();
}

inline float __shfl_sync(unsigned mask, float v, int src, int width) {
  int p;
  unsigned first;
  Segment& s = meeting(mask, p, first);
  const unsigned lane = threadIdx.x % 32;
  if (width < 1 || width > __builtin_popcount(mask) || (width & (width - 1)))
    std::abort();
  float* slots = s.slot[flip[p]];
  flip[p] ^= 1;
  slots[lane - first] = v;
  s.meet();
  return slots[lane / width * width + src % width - first];
}

template <class F, class... A>
void host_launch(dim3 grid, unsigned threads, F f, A... args) {
  for (unsigned b = 0; b < grid.x; ++b)
    for (unsigned w0 = 0; w0 < threads; w0 += 32) {
      Warp lanes_of_warp;
      std::vector<std::thread> lanes;
      for (unsigned t = w0; t < std::min(threads, w0 + 32); ++t)
        lanes.emplace_back([&, b, t] {
          blockIdx = {b, 0, 0};
          threadIdx = {t, 0, 0};
          warp = &lanes_of_warp;
          f(args...);
        });
      for (auto& l : lanes) l.join();
    }
}
"""

# the C entries the host tests run: the tile kernel (G = 8) and one thread
# a point
HOST_ENTRIES = {'tile8': tfk.LK_ENTRIES['tile'],
                'per_thread': tfk.LK_ENTRIES['per_thread']}


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    """csrc/lk_pyramidal.cu built for the host with g++ and the shim, its
    C entries' signatures declared (ctypes)."""
    import ctypes
    import re
    import shutil
    import subprocess
    from fastmot_tpu_torch.ops.cuda_build import CSRC
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    d = tmp_path_factory.mktemp('lk_host')
    (d / 'cuda_runtime.h').write_text(HOST_SHIM)
    src, n = re.subn(r'(\w+<[\w, ]+>)<<<(\w+), (\w+), \w+, \w+>>>\(',
                     r'host_launch(\2, \3, \1, ',
                     (CSRC / 'lk_pyramidal.cu').read_text())
    assert n == 2
    (d / 'lk.cpp').write_text(src)
    subprocess.run(['g++', '-O1', '-std=c++17', '-pthread',
                    '-ffp-contract=off', '-fPIC', '-shared', '-I', str(d),
                    '-o', str(d / 'lk.so'), str(d / 'lk.cpp')],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / 'lk.so'))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in HOST_ENTRIES.values():
        getattr(lib, entry).argtypes = [
            ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(ci), ci,
            vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    return lib


def host_run(entry, prev, cur, pts, valid, spec):
    """One call of a host-built C entry on CPU tensors [S, ...]; returns
    (new_pts, status, err)."""
    import ctypes
    table = tfk.lk_level_table(prev, cur, pts, valid, spec)
    got = (torch.empty_like(pts), torch.empty_like(valid),
           torch.empty(valid.shape))
    n = len(table.dims)
    code = entry(
        (ctypes.c_void_p * n)(*(t.data_ptr() for t in prev)),
        (ctypes.c_void_p * n)(*(t.data_ptr() for t in cur)),
        (ctypes.c_int * (2 * n))(*(d for hw in table.dims for d in hw)), n,
        pts.data_ptr(), valid.data_ptr(), *(g.data_ptr() for g in got),
        table.streams, table.points, spec.win, spec.iters, None)
    assert code == 0
    return got


def test_host_builds_have_their_tile_lanes(host_kernel):
    assert host_kernel.lk_tile_lanes() == 8
    assert host_kernel.lk_tile_points() == 16


@pytest.mark.parametrize('build', sorted(HOST_ENTRIES))
@pytest.mark.parametrize('max_level,iters',
                         [(2, 10), (1, 10), (2, 4), (2, 0), (0, 3)])
def test_kernel_source_on_the_host_equals_plain_version(host_kernel, build,
                                                        max_level, iters):
    """The kernel's source, run on the host over two streams whose frames
    differ, gives what the plain version gives, bit for bit, at the main
    path's window over other level counts and step caps (where ATen sums
    in the kernel's order, which the first check holds): the tile kernel
    and the one-thread-a-point kernel."""
    test_aten_sums_rows_in_the_kernels_order()
    spec = tfk.FlowSpec(**dict(SPEC_ARGS, max_level=max_level, iters=iters))
    frames = [lk_frames(seed=s) for s in (0, 1)]
    prev, cur = ([tfk.preprocess(spec, T(np.stack([f[i] for f in frames])))
                  [1] for i in (0, 1)])
    pts, valid = lk_points()
    pts = torch.stack([T(pts), T(pts[::-1].copy())])
    valid = torch.stack([T(valid), T(valid[::-1].copy())])
    got = host_run(getattr(host_kernel, HOST_ENTRIES[build]), prev, cur,
                   pts, valid, spec)
    assert_bit_equal(got, tfk.lk_pyramidal_reference(prev, cur, pts, valid,
                                                     spec))


# the points of one warp-aligned group of four (a warp of the tile
# kernel), by their steps at the finest level:
# invalid (none), on the flat window (the gate stops it after one), on the
# fresh noise (the cap, 10), and a random point
WARP_KINDS = ('invalid', 'flat', 'capped', 'random')


def warp_case(per_stream=30, n_streams=2):
    """Frames of two streams (seeds 0 and 1) and ``per_stream`` points a
    stream, the flat index f of each point of kind WARP_KINDS[f % 4], so
    warps straddle the streams (30 is not a multiple of a block's 16
    points); returns (spec, prev, cur, pts, valid, steps [S, P, L] of the
    per-point reference)."""
    spec = TSPEC
    frames = [lk_frames(seed=s) for s in range(n_streams)]
    prev, cur = ([tfk.preprocess(spec, T(np.stack([f[i] for f in frames])))
                  [1] for i in (0, 1)])
    rng = np.random.default_rng(5)
    n = per_stream * n_streams
    kind = np.arange(n) % 4
    pts = np.stack([rng.uniform(0, 79, n), rng.uniform(0, 59, n)], -1)
    pts[kind == 1] = FLAT_PT
    # a noise point whose steps reach the cap at the finest level on every
    # stream's frames
    capped = None
    for p in NOISE_PTS:
        steps = [lk_point_by_point([x[s].numpy() for x in prev],
                                   [x[s].numpy() for x in cur],
                                   np.array([p], F32), np.array([True]),
                                   spec, aten_sum_lanes())[3]
                 for s in range(n_streams)]
        if all(st[0, 0] == spec.iters for st in steps):
            capped = p
            break
    assert capped is not None
    pts[kind == 2] = capped
    pts = pts.astype(F32).reshape(n_streams, per_stream, 2)
    valid = (kind != 0).reshape(n_streams, per_stream)
    steps = np.stack([lk_point_by_point(
        [x[s].numpy() for x in prev], [x[s].numpy() for x in cur], pts[s],
        valid[s], spec, aten_sum_lanes())[3] for s in range(n_streams)])
    return spec, prev, cur, T(pts), T(valid), steps


@pytest.mark.parametrize('build', sorted(HOST_ENTRIES))
def test_kernel_source_on_the_host_warps_of_mixed_step_counts(host_kernel,
                                                              build):
    """Warps whose tiles take 0, 1 and 10 steps at the same level, and
    blocks and warps that straddle two streams: the host build equals the
    plain version bit for bit."""
    test_aten_sums_rows_in_the_kernels_order()
    spec, prev, cur, pts, valid, steps = warp_case()
    finest = steps[..., 0].reshape(-1)
    kind = np.arange(len(finest)) % 4
    assert np.all(finest[kind == 0] == 0) and np.all(finest[kind == 1] == 1)
    assert np.all(finest[kind == 2] == spec.iters)
    assert pts.shape[1] % 16 and pts.shape[1] % 4
    got = host_run(getattr(host_kernel, HOST_ENTRIES[build]), prev, cur,
                   pts, valid, spec)
    assert_bit_equal(got, tfk.lk_pyramidal_reference(prev, cur, pts, valid,
                                                     spec))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (python -m pytest '
                    'tests/test_torch_lk_kernel.py -m cuda on a machine '
                    'with the card)')
    return torch.device('cuda')


def main_path_case(n_streams, f_cap, device, seed=0):
    """Pyramids of textured 1280x720 frames (cfg/mot.json's flow: opt
    scale 0.5, 6 levels), each stream its own texture and drift, and
    f_cap x 32 + 256 points a stream, 90 % valid."""
    spec = tfk.FlowSpec(size=(1280, 720), opt_scale=(0.5, 0.5),
                        bg_scale=(0.1, 0.1))
    rng = np.random.default_rng(seed)
    pairs = []
    for s in range(n_streams):
        base = ndi.gaussian_filter(rng.uniform(0, 255, (760, 1320)), 1.5)
        dx, dy = 20 + s, 20 - 2 * s
        pairs.append([np.repeat(base[a:a + 720, b:b + 1280, None], 3, -1)
                      .astype(np.uint8) for a, b in ((20, 20), (dy, dx))])
    prev, cur = ([tfk.preprocess(spec, torch.as_tensor(
        np.stack([p[i] for p in pairs]), device=device))[1]] for i in (0, 1))
    n = f_cap * tfk.KP_PER_TRACK + tfk.BG_KP
    pts = np.stack([rng.uniform(-2, 642, (n_streams, n)),
                    rng.uniform(-2, 362, (n_streams, n))], -1)
    valid = rng.uniform(size=(n_streams, n)) < 0.9
    return (spec, prev[0], cur[0],
            torch.as_tensor(pts, dtype=torch.float32, device=device),
            torch.as_tensor(valid, device=device))


def assert_lk_close(got, want, all_close=True):
    """The tolerance of the port against JAX (module constants), its bound
    on the largest difference only with ``all_close``."""
    g_pts, g_ok = got[0].cpu().reshape(-1, 2), got[1].cpu().reshape(-1)
    w_pts, w_ok = want[0].cpu().reshape(-1, 2), want[1].cpu().reshape(-1)
    assert (g_ok == w_ok).float().mean().item() > STATUS_SHARE
    both = g_ok & w_ok
    assert both.sum() > 0.5 * len(both)
    diff = (g_pts[both] - w_pts[both]).abs().amax(1)
    assert (diff < CLOSE_PX).float().mean().item() > CLOSE_SHARE
    assert diff.max().item() < MAX_PX or not all_close


# (streams, flow budget): the main path's and phase 13's largest
# (chip_smoke.py LK_CASES)
CARD_CASES = [(1, 48), (8, 128)]


def launched():
    """The LK kernels' launches so far, both designs."""
    return sum(tfk.lk_pyramidal.launches.values())


def run_kernel(design, prev, cur, pts, valid, spec):
    """One launch of ``design``'s kernel through its C entry, past the
    wrapper's pick (and its launch counts)."""
    outputs, args = tfk.lk_launch_args(prev, cur, pts, valid, spec)
    assert getattr(tfk.lk_library(), tfk.LK_ENTRIES[design])(*args) == 0
    return outputs


@pytest.mark.cuda
@pytest.mark.parametrize('n_streams,f_cap', CARD_CASES)
def test_lk_kernel_matches_plain_on_card(cuda_device, n_streams, f_cap):
    spec, prev, cur, pts, valid = main_path_case(n_streams, f_cap,
                                                 cuda_device)
    before = launched()
    got = tfk.lk_pyramidal(prev, cur, pts, valid, spec)
    torch.cuda.synchronize()
    assert launched() == before + 1
    assert [tuple(g.shape) for g in got] == [tuple(pts.shape)] + \
        [tuple(valid.shape)] * 2
    assert all(bool(torch.isfinite(g).all()) for g in (got[0], got[2]))
    # the kernel rounds as the plain version does on the CPU, bit for bit
    # where ATen sums in the kernel's order; run on the card the plain
    # version sums in CUDA's order, which can move a point that never
    # settles by pixels (chip_smoke.py, LK_MAX_PX)
    want = tfk.lk_pyramidal_reference(
        [p.cpu() for p in prev], [c.cpu() for c in cur], pts.cpu(),
        valid.cpu(), spec)
    assert_lk_close(got, want)
    test_aten_sums_rows_in_the_kernels_order()
    assert_bit_equal([g.cpu() for g in got], want)
    assert_lk_close(got, tfk.lk_pyramidal_reference(prev, cur, pts, valid,
                                                    spec), all_close=False)


@pytest.mark.cuda
@pytest.mark.parametrize('n_streams,f_cap', CARD_CASES)
def test_tile_kernel_equals_per_thread_kernel_on_card(cuda_device,
                                                      n_streams, f_cap):
    spec, prev, cur, pts, valid = main_path_case(n_streams, f_cap,
                                                 cuda_device, 3)
    tile = run_kernel('tile', prev, cur, pts, valid, spec)
    thread = run_kernel('per_thread', prev, cur, pts, valid, spec)
    torch.cuda.synchronize()
    assert_bit_equal([t.cpu() for t in tile], [t.cpu() for t in thread])


@pytest.mark.cuda
@pytest.mark.parametrize('n_streams,f_cap', CARD_CASES)
def test_wrapper_launches_the_pick_of_lk_design_on_card(cuda_device,
                                                        n_streams, f_cap):
    """One stream takes the tile kernel and 8 streams one thread a point
    on an H100 (132 SMs); on any card, lk_design's pick."""
    spec, prev, cur, pts, valid = main_path_case(n_streams, f_cap,
                                                 cuda_device, 4)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    pick = tfk.lk_design(valid.numel(), sms)
    if sms == 132:
        assert pick == ('tile' if n_streams == 1 else 'per_thread')
    before = dict(tfk.lk_pyramidal.launches)
    tfk.lk_pyramidal(prev, cur, pts, valid, spec)
    torch.cuda.synchronize()
    assert tfk.lk_pyramidal.launches == {d: n + (d == pick)
                                         for d, n in before.items()}


@pytest.mark.cuda
def test_lk_kernel_is_bitwise_reproducible(cuda_device):
    spec, prev, cur, pts, valid = main_path_case(8, 128, cuda_device, 1)
    a = tfk.lk_pyramidal(prev, cur, pts, valid, spec)
    b = tfk.lk_pyramidal(prev, cur, pts, valid, spec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_lk_core_launches_the_kernel_once_a_call(cuda_device):
    spec, prev, cur, pts, valid = main_path_case(2, 32, cuda_device, 2)
    full = pts / 0.5
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    picks = [tfk.lk_design(valid.numel(), sms),
             tfk.lk_design(valid[0].numel(), sms)]
    before = dict(tfk.lk_pyramidal.launches)
    tfk.lk_core(spec, prev, cur, full, valid)
    assert launched() == sum(before.values()) + 1
    tfk.lk_core(spec, [p[0] for p in prev], [c[0] for c in cur], full[0],
                valid[0])
    torch.cuda.synchronize()
    # each call launches lk_design's pick, and nothing else
    assert tfk.lk_pyramidal.launches == {d: n + picks.count(d)
                                         for d, n in before.items()}


@pytest.mark.cuda
def test_lk_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    spec, prev, cur, pts, valid = main_path_case(1, 32, cuda_device)
    before = dict(tfk.lk_pyramidal.launches)
    with pytest.raises(ValueError, match='contiguous'):
        tfk.lk_pyramidal(prev, [_noncontiguous(cur[0])] + cur[1:], pts,
                         valid, spec)
    with pytest.raises(ValueError, match='window'):
        tfk.lk_pyramidal(prev, cur, pts, valid,
                         tfk.FlowSpec(**dict(vars(spec), win=4)))
    with pytest.raises(ValueError, match='cpu'):
        tfk.lk_pyramidal(prev, cur, pts, valid.cpu(), spec)
    assert tfk.lk_pyramidal.launches == before
