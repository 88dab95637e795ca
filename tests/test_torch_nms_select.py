"""The YOLO postprocess kernels of the port (``csrc/nms_waves.cu``'s
``nms_select_forward``, wrapper ``ops.nms_waves.nms_select`` behind
``detector.nms_and_gate`` on the card, plain version
``detector.nms_and_gate_reference``): the confidence and label gates, the
pixel boxes, the stable top MAX_RAW candidates by a radix select, their
DIoU and same-label bits computed from the boxes (no [S, 1,024, 1,024]
matrix), the greedy waves, the area and aspect-ratio gates and the stable
order by label, then score, in three launches.

On the CPU:

- the plain version against the JAX package's ``_nms_and_gate`` (``vmap``
  over streams): the valid mask, the kept boxes and labels equal, the
  scores within 1e-6 relative (the existing parity test's rule; JAX's
  order of the rows it does not keep may differ);
- the kernels' own source built for the host with g++ through
  tests/cuda_host_shim.py (blocks in turn on a team of host threads; the
  kernels stride their loops by the block's thread count, so teams of 32
  and 64 threads compute what 1,024 do): every output, in its order, bit
  for bit the plain version's on seeded cases (more than 1,024
  candidates past the confidence gate, tied scores, several labels
  through an all-true mask, labels outside the mask and outside its
  range, boxes that fail each gate, 1 to 3 streams, fewer candidates than
  MAX_RAW and than MAX_DETS), and every output's sha256 as the first
  design gave it (``OUTPUT_SHA256``); on cases at the select's edges
  (``EDGE_KINDS``: a radix select that stops after each of its three
  digits or cuts the K-th score's equals by index across the cluster's
  blocks, row counts that are not a multiple of a block's slice, N = K
  and N = K + 1, K not a power of two with M < K, several streams), bit
  for bit the plain version and the sha256 a host build of the first
  design's source gave (``EDGE_SHA256``), also with the select's keys in
  scratch rather than shared memory. The select runs as a thread block
  cluster in the host shim (``clusters=True``). The host build's DIoU
  takes glibc's ``powf``, the plain version on the CPU torch's CPU
  ``pow``, the card CUDA's ``powf``: they round apart by a few ulps on
  some inputs
  (chip_smoke.py phase 21 counts them), which can flip a box only where
  its DIoU lies within those ulps of the threshold; none does on these
  cases.

On the card (marker ``cuda``; they skip without one):

    python -m pytest tests/test_torch_nms_select.py -m cuda
"""
import hashlib
from unittest import mock

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch.ops import geometry as tgeom
from fastmot_tpu_torch.ops import nms_waves as nw

from .cuda_host_shim import build_host

F32 = np.float32
KINDS = ('contested', 'streams', 'masked', 'few', 'tiny')
SCALARS = (0.25, 0.5, 800000, 1.2)     # conf, nms, max_area, min_ar


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def clustered_rows(rng, n, n_labels, n_clusters=40, tie_step=0.1):
    """``n`` decoded rows [x, y, w, h, obj, label, cls] in unit
    coordinates around ``n_clusters`` centres (so that DIoU suppresses),
    scores on a grid of ``tie_step`` (ties), and rows failing each box
    gate: zero or negative width, an area above 800,000 px at 1280 x 720,
    an aspect ratio below 1.2."""
    centers = rng.uniform(0.05, 0.95, (n_clusters, 2))
    xy = centers[rng.integers(0, n_clusters, n)] \
        + rng.normal(0, 0.006, (n, 2))
    wh = rng.uniform(0.02, 0.08, (n, 2)) * np.array([1.0, 2.5])
    obj = np.round(rng.uniform(0.3, 1.0, n) / tie_step) * tie_step
    cls = np.round(rng.uniform(0.5, 1.0, n) / tie_step) * tie_step
    label = rng.integers(0, n_labels, n)
    rows = np.concatenate([xy - wh / 2, wh, obj[:, None], label[:, None],
                           cls[:, None]], 1)
    bad = rng.permutation(n)[:40]
    rows[bad[:10], 2] = -0.01                   # non-positive width
    rows[bad[10:20], 2:4] = [0.9, 0.95]         # area above the gate
    rows[bad[20:30], 3] = rows[bad[20:30], 2]   # aspect ratio 1 < 1.2
    rows[bad[30:40], 2:4] = 0.0                 # one pixel
    return rows.astype(F32)


def select_case(kind, seed=0):
    """(det_out [.., N, 7], label_mask, scale_wh, offset) of a kind of
    case, numpy."""
    rng = np.random.default_rng(seed)
    scale = np.array([1280, 720, 1280, 720], F32)
    offset = np.array([0.0, 0.0], F32)
    if kind == 'contested':
        det = clustered_rows(rng, 2000, 3, 12)
        return det, np.ones(3, bool), scale, offset
    if kind == 'streams':
        det = np.stack([clustered_rows(rng, 1500, 2, 16) for _ in range(3)])
        return det, np.ones(2, bool), scale, np.array([3.0, -5.0], F32)
    if kind == 'masked':
        det = clustered_rows(rng, 1300, 4, 12)
        det[:60, 5] = -1.0                      # clamped to label 0
        det[60:120, 5] = 7.0                    # clamped to label 3
        return det, np.array([True, False, True, False]), scale, offset
    if kind == 'few':
        det = np.stack([clustered_rows(rng, 300, 2, 10) for _ in range(2)])
        return det, np.ones(2, bool), scale, offset
    if kind == 'tiny':
        det = clustered_rows(rng, 50, 1, 5)
        return det, np.ones(1, bool), scale, offset
    raise ValueError(kind)


def with_scores(rows, scores):
    """``rows`` with objectness ``scores`` and class probability 1, so that
    each row's score is exactly its ``scores`` entry."""
    rows = rows.copy()
    rows[..., 4] = scores
    rows[..., 6] = 1.0
    return rows


def score_groups(rng, n, groups, rest=0.3):
    """``n`` scores in a random order: ``groups`` of (count, value) rows,
    the value a float, or the bits of one as an int; the rest ``rest``."""
    scores = np.full(n, rest, F32)
    at = 0
    for count, value in groups:
        if isinstance(value, int):
            value = np.array([value], np.uint32).view(F32)[0]
        scores[at:at + count] = value
        at += count
    return scores[rng.permutation(n)]


# bits of 0.55 with the last digit's 10 bits clear
BASE_55 = int(np.array([0.55], F32).view(np.uint32)[0]) & ~0x3FF
# cases at the select's edges: where its radix select of 11-, 11- and
# 10-bit digits stops (after each digit, or past the last, where the K-th
# score's equals are cut by index across the cluster's blocks), row counts
# that are not a multiple of a block's slice, N = K and N = K + 1, K not a
# power of two with M < K, several streams. (det, mask, scale, offset,
# keep, out); keep and out None: the wrapper's own
EDGE_KINDS = ('stop_first', 'stop_second', 'stop_third', 'cut',
              'cut_streams', 'ragged', 'one_over', 'equal', 'keep_700')


def edge_case(kind, seed=5):
    rng = np.random.default_rng(seed)
    scale = np.array([1280, 720, 1280, 720], F32)
    offset = np.array([0.0, 0.0], F32)
    keep = out = None
    groups = {
        'stop_first': [(1, s) for s in rng.uniform(0.5, 0.62, 1024)],
        'stop_second': [(424, 0.6), (600, 0.55), (200, 0.52)],
        'stop_third': [(400, BASE_55 + 700), (624, BASE_55 + 300),
                       (300, BASE_55 + 100)],
        'cut': [(700, 0.9), (800, 0.7)]}
    if kind in groups:
        rows = clustered_rows(rng, 2000, 3, 40)
        det = with_scores(rows, score_groups(rng, 2000, groups[kind]))
    elif kind == 'cut_streams':
        det = np.stack([with_scores(clustered_rows(rng, 1600, 2, 30),
                                    score_groups(rng, 1600,
                                                 [(above, 0.9), (800, 0.7)]))
                        for above in (300, 700, 1023)])
    elif kind == 'ragged':
        det = clustered_rows(rng, 1799, 3, 30)
    elif kind == 'one_over':
        det = clustered_rows(rng, 1025, 2, 30)
    elif kind == 'equal':
        det = np.stack([clustered_rows(rng, 1024, 2, 30) for _ in range(2)])
    elif kind == 'keep_700':
        det = clustered_rows(rng, 2000, 3, 40)
        keep, out = 700, 50
    else:
        raise ValueError(kind)
    mask = np.ones(3, bool)
    return det, mask, scale, offset, keep, out


def select_passes(keys, k):
    """Where the select's radix select stops on one stream's 32-bit score
    keys (numpy): after digit 0, 1 or 2, or 3 past the last (a cut among
    the K-th key's equals); None where N <= K."""
    if len(keys) <= k:
        return None
    prefix = high = 0
    need = k
    for q, (shift, width) in enumerate(((21, 11), (10, 11), (0, 10))):
        mask = (1 << width) - 1
        inside = keys[(keys & high) == prefix]
        digits = (inside >> shift) & mask
        counts = np.bincount(digits.astype(np.int64), minlength=mask + 1)
        above = np.cumsum(counts[::-1])
        d = mask - int(np.searchsorted(above, need))
        c = int(above[mask - d] - counts[d])
        prefix |= d << shift
        high |= mask << shift
        need -= c
        if counts[d] == need:
            return q
    return 3


def score_keys(det, mask, conf=SCALARS[0]):
    """The select's 32-bit score keys of one stream's rows (numpy)."""
    score = det[..., 4] * det[..., 6]
    label = np.clip(det[..., 5].astype(np.int64), 0, len(mask) - 1)
    gated = np.where(mask[label] & (score >= conf), score, F32(-1.0))
    u = gated.astype(F32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def output_sha256(outputs):
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# every seeded case's outputs (seed 1) as the first design of the kernels
# gave them (the plain version's too)
OUTPUT_SHA256 = {
    'contested':
        'd24db6fddb4f7abc43d1a385c4747b59836721b8f78bb407a376c0164c7a3ff1',
    'streams':
        'a6deaa1b72b95c3a4b2fe596ccc8b962978eb3edc6de950605ad773fc35e5071',
    'masked':
        'e920ba923dc5ffe6d24b28e0bf58d26ce195d1466c3f5bc04eda26756f10fa97',
    'few':
        '3730ca80a8f1fdb52e9d7a470d90cad99682bd1caa27d078994a1d2b5a9217fe',
    'tiny':
        'b29830fa689feba3a23566fdb97671402e683b3017d60fda2407faf0b556b383',
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six workers on the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# each edge case's outputs as a host build of the first design's source
# (commit 1fcedb2's csrc/nms_waves.cu) gave them
EDGE_SHA256 = {
    'stop_first':
        'eb9d33e010885d60a6c4f018ef24a3aa22a1d99d2147f06048e7e25a1a482b98',
    'stop_second':
        'ce91be73e137ffe931885e6c01498a1b9880ce7f3cfafa66bd43cda9f3653162',
    'stop_third':
        '65eecbe468fe99e418dc415a74e1015b7b3e3668749624fcbea63f36a4512dfb',
    'cut':
        '7e48973fbbdd35c0b723c202a0c106fd2c04a7b2b0c4821f96b60340076992d7',
    'cut_streams':
        '62dbd8dc346f3f09cc7c69fed4ba5e2aec83585585807fef2df46375ade7d0da',
    'ragged':
        'de94b9e45a46f809f917982413c33bb95b2a01bb181647c632ffb1949dba217d',
    'one_over':
        '193add87c4861b6865e4c0f40d058dc484316ac2c43650b526c700bfd41c4f7f',
    'equal':
        '59b09aa308e71a2af5e78d187fbe3eaae68552c2195e74e2b4b6a3430022c91a',
    'keep_700':
        '0f444175768385ef8da6cb8c02cddc57d6723985412180286f9504b59632378e',
}


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    return nw.declare(build_host('nms_waves', tmp_path_factory, launches=2,
                                 clusters=True))


def torch_case(case):
    return tuple(T(a) for a in case)


def keep_out(det_out):
    k = min(tdet.MAX_RAW, det_out.shape[-2])
    return k, min(k, tdet.MAX_DETS)


@pytest.fixture(scope='module')
def host_kernel_keys_in_scratch(tmp_path_factory):
    """A host build whose select keeps no key in shared memory."""
    return nw.declare(build_host('nms_waves', tmp_path_factory, launches=2,
                                 clusters=True,
                                 defines=('-DNMS_SELECT_SMEM_MAX=1',)))


def host_select(lib, case, threads=32, device='cpu', keep=None, out=None):
    """``nms_and_gate`` through the host build (or, ``threads`` None, the
    card's library on CUDA tensors), keeping ``keep`` candidates and
    writing ``out`` (None: the wrapper's)."""
    det, mask, scale, offset = (t.to(device) for t in case)
    if threads is not None:
        lib.set_host_threads(threads)
    k, m = keep_out(det)
    outputs, args, _ = nw.nms_select_launch_args(
        det, mask, *SCALARS, scale, offset, keep or k, out or m)
    assert lib.nms_select_forward(*args) == 0
    return outputs


def plain(case, keep=None, out=None):
    """The plain version, keeping ``keep`` candidates and writing ``out``
    (None: MAX_RAW and MAX_DETS)."""
    det, mask, scale, offset = case
    with mock.patch.object(tdet, 'MAX_RAW', keep or tdet.MAX_RAW), \
            mock.patch.object(tdet, 'MAX_DETS', out or tdet.MAX_DETS):
        return tdet.nms_and_gate_reference(det, mask, *SCALARS, scale,
                                           offset)


def test_cases_are_what_they_say():
    """More than MAX_RAW candidates pass the gates where the case says so,
    scores tie, detections are kept, and rows that fail a gate fill the
    outputs' ends where fewer than MAX_DETS are kept."""
    for kind in KINDS:
        det, mask, scale, offset = torch_case(select_case(kind, seed=1))
        score = det[..., 4] * det[..., 6]
        passed = (score >= SCALARS[0]).sum(-1)
        if kind in ('contested', 'streams', 'masked'):
            assert bool((passed > tdet.MAX_RAW).all()), kind
            assert len(torch.unique(score)) < score.numel() // 4, kind
        tlbr, label, conf, valid = plain((det, mask, scale, offset))
        assert int(valid.sum()) >= 2, kind
        if kind in ('few', 'tiny'):
            assert not bool(valid.all()), kind
        if kind == 'masked':
            # label -1 reads the mask at 0, 7 at 3
            assert set(label[valid].tolist()) == {-1, 0, 2}


@pytest.mark.parametrize('kind', KINDS)
def test_plain_version_matches_jax(kind):
    import jax
    import jax.numpy as jnp
    from fastmot_tpu import detector as jdet
    det, mask, scale, offset = select_case(kind, seed=3)

    def one(d):
        return jdet._nms_and_gate(d, jnp.asarray(mask), *SCALARS,
                                  jnp.asarray(scale), jnp.asarray(offset))
    fn = jax.vmap(one) if det.ndim == 3 else one
    want = [np.asarray(w) for w in fn(jnp.asarray(det))]
    got = plain(torch_case((det, mask, scale, offset)))
    valid = want[3]
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy()[valid], want[0][valid])
    np.testing.assert_array_equal(got[1].numpy()[valid], want[1][valid])
    np.testing.assert_allclose(got[2].numpy()[valid], want[2][valid],
                               rtol=1e-6)


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in KINDS]
                         + [('streams', 64)])
def test_host_build_equals_plain_version(host_kernel, kind, threads):
    case = torch_case(select_case(kind, seed=1))
    got = host_select(host_kernel, case, threads)
    for g, w in zip(got, plain(case)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize('kind', KINDS)
def test_host_outputs_equal_the_first_design(host_kernel, kind):
    got = host_select(host_kernel, torch_case(select_case(kind, seed=1)))
    assert output_sha256(got) == OUTPUT_SHA256[kind]


def test_edge_cases_are_what_they_say():
    """Each edge case's select stops where its name says, at every
    stream."""
    want = {'stop_first': {0}, 'stop_second': {1}, 'stop_third': {2},
            'cut': {3}, 'cut_streams': {3}, 'one_over': None,
            'equal': {None}}
    for kind in EDGE_KINDS:
        det, mask, scale, offset, keep, out = edge_case(kind)
        k = keep or min(tdet.MAX_RAW, det.shape[-2])
        stops = {select_passes(score_keys(d, mask), k)
                 for d in (det if det.ndim == 3 else det[None])}
        if kind in want and want[kind] is not None:
            assert stops == want[kind], kind
        n = det.shape[-2]
        if kind == 'ragged':
            assert n % 256 and n % 8 and n > k
        if kind == 'one_over':
            assert n == k + 1
        if kind == 'keep_700':
            assert k & (k - 1) and out < k and n > k


@pytest.mark.parametrize('kind', EDGE_KINDS)
def test_host_build_at_the_edges(host_kernel, kind):
    """Bit for bit the plain version, and the first design's outputs."""
    det, mask, scale, offset, keep, out = edge_case(kind)
    case = torch_case((det, mask, scale, offset))
    got = host_select(host_kernel, case, 64 if kind == 'cut' else 32,
                      keep=keep, out=out)
    for g, w in zip(got, plain(case, keep, out)):
        assert g.dtype == w.dtype and torch.equal(g, w), kind
    assert output_sha256(got) == EDGE_SHA256[kind]


@pytest.mark.parametrize('kind', ['cut_streams', 'stop_third', 'ragged',
                                  'keep_700'])
def test_keys_in_scratch(host_kernel_keys_in_scratch, kind):
    """With the select's keys in scratch, not shared memory: the same
    outputs."""
    det, mask, scale, offset, keep, out = edge_case(kind)
    got = host_select(host_kernel_keys_in_scratch,
                      torch_case((det, mask, scale, offset)), keep=keep,
                      out=out)
    assert output_sha256(got) == EDGE_SHA256[kind]


def test_scratch_layout_agrees(host_kernel):
    for s, n, k in ((1, 16128, 1024), (3, 1500, 1024), (2, 301, 301),
                    (1, 50, 50)):
        assert host_kernel.nms_select_scratch_words(s, n, k) \
            == nw.select_scratch_words(s, n, k)


def test_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    case = torch_case(select_case('few', seed=1))
    before = nw.nms_select.launches
    monkeypatch.setattr(nw, 'nms_waves_library', lambda: pytest.fail(
        'the kernel library was loaded for CPU tensors'))
    det, mask, scale, offset = case
    for g, w in zip(tdet.nms_and_gate(det, mask, *SCALARS, scale, offset),
                    plain(case)):
        assert torch.equal(g, w)
    assert nw.nms_select.launches == before


def test_wrapper_raises_on_other_devices():
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tdet.nms_and_gate(torch.zeros((40, 7), device=meta),
                          torch.ones(2, dtype=torch.bool, device=meta),
                          *SCALARS, torch.ones(4, device=meta),
                          torch.zeros(2, device=meta))


@pytest.mark.parametrize('fault', ['rows', 'dtype', 'mask', 'scale', 'keep',
                                   'out'])
def test_launch_args_raise_on_each_fault(fault):
    det = torch.zeros((2, 60, 8 if fault == 'rows' else 7),
                      dtype=torch.float64 if fault == 'dtype'
                      else torch.float32)
    mask = torch.ones(3, dtype=torch.int32 if fault == 'mask'
                      else torch.bool)
    scale = torch.ones(3 if fault == 'scale' else 4)
    keep = 61 if fault == 'keep' else 60
    out = 61 if fault == 'out' else 40
    with pytest.raises(ValueError, match='nms_waves'):
        nw.nms_select_launch_args(det, mask, *SCALARS, scale,
                                  torch.zeros(2), keep, out)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', KINDS)
def test_kernel_matches_plain_version(cuda, kind):
    """Bit for bit the plain version on the card and the first design; no
    DIoU matrix on the card path."""
    case = torch_case(select_case(kind, seed=1))
    on_card = tuple(t.to(cuda) for t in case)
    before = nw.nms_select.launches
    with mock.patch.object(tgeom, 'diou_matrix', side_effect=AssertionError(
            'the DIoU matrix was built on the card path')):
        got = tdet.nms_and_gate(on_card[0], on_card[1], *SCALARS,
                                *on_card[2:])
    torch.cuda.synchronize()
    assert nw.nms_select.launches == before + 1
    for g, w in zip(got, plain(on_card)):
        assert torch.equal(g, w)
    assert output_sha256(got) == OUTPUT_SHA256[kind]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', EDGE_KINDS)
def test_kernel_at_the_edges(cuda, kind):
    """The card's build on the edge cases: bit for bit the plain version
    and the first design's outputs."""
    det, mask, scale, offset, keep, out = edge_case(kind)
    case = torch_case((det, mask, scale, offset))
    got = host_select(nw.nms_waves_library(), case, None, 'cuda', keep, out)
    torch.cuda.synchronize()
    for g, w in zip(got, plain(case, keep, out)):
        assert torch.equal(g.cpu(), w), kind
    assert output_sha256(got) == EDGE_SHA256[kind]


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(cuda):
    det, mask, scale, offset = (t.to(cuda) for t in torch_case(
        select_case('streams', seed=1)))
    tdet.nms_and_gate(det, mask, *SCALARS, scale, offset)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        tdet.nms_and_gate(det, mask, *SCALARS, scale, offset)
    finally:
        torch.cuda.set_sync_debug_mode(0)
