"""The detectors' NMS and SSD-merge kernels of the port (``csrc/nms_waves.cu``,
wrappers ``ops.geometry.greedy_suppress`` and ``ops.nms_waves.merge_labels``):
the NMS waves and the merge's label rounds run to their ends on the device.

On the CPU the kernels' own source is built for the host with g++ through
tests/cuda_host_shim.py (a launch's blocks in turn on a team of host
threads, the ballots meetings of a warp's 32; the kernels stride their
loops by the block's thread count and take whole warps, so the tests run
them with 32, 64 or 96 threads a block). Each build equals the plain
versions (``greedy_suppress_reference``, ``merge_labels_reference``) bit for
bit, every output, on seeded cases: tied scores, suppression chains one to
six waves deep, all boxes invalid, sizes that are not multiples of 32, eight
problems in one call, -inf overlaps across labels as the YOLO path makes
them, NaN overlaps and scores, and the full-width contested case of
chip_smoke.py phase 20 (1,024 same-label boxes in chains eight waves deep);
merges whose components are long chains, stars, singletons and invalid
rows. The plain versions and the host build equal the JAX package's
``_greedy_suppress`` and its SSD postprocess exactly, and ``nms_and_gate``
and the SSD postprocess through the host build equal their plain runs.
Every output of every seeded case is, to the bit, what the first design of
the kernels gave (``OUTPUT_SHA256``).

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the CPU tests that need it):

    python -m pytest tests/test_torch_nms_kernel.py -m cuda
"""
import hashlib

import numpy as np
import pytest
import torch

from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch.ops import geometry as tgeom
from fastmot_tpu_torch.ops import nms_waves as nw

from .cuda_host_shim import build_host

F32 = np.float32
SUPPRESS_KINDS = ('ties', 'chains', 'invalid', 'odd', 'batched',
                  'cross_label', 'nan', 'contested')
MERGE_KINDS = ('chains', 'stars', 'invalid', 'odd', 'batched', 'ssd')
# the waves each kind's problems take, at most (the plain loop's count)
CHAIN_DEPTHS = (1, 2, 3, 4, 5, 6)


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


def random_boxes(rng, n, field=(640.0, 480.0), size=(20.0, 120.0)):
    xy = rng.uniform(0, 1, (n, 2)) * np.array(field)
    wh = rng.uniform(*size, (n, 2))
    return np.round(np.concatenate([xy, xy + wh], -1)).astype(F32)


def chain_boxes(depth, x0, y0, width=40.0, height=80.0, step=10.0):
    """A chain of 2 * depth - 1 boxes along x, each overlapping only its
    neighbours beyond 0.5 (IoU 0.6, DIoU 0.53; two apart 0.33): with
    scores falling along it, greedy keeps every other box, one a wave."""
    n = 2 * depth - 1
    x = x0 + step * np.arange(n)
    return np.stack([x, np.full(n, y0), x + width - 1,
                     np.full(n, y0 + height - 1)], -1).astype(F32)


def contested_nms(seed=0, n=1024, chain=16, field=(1280, 720)):
    """chip_smoke.py phase 20's contested NMS: ``n`` same-label candidates
    in clusters, each a chain of ``chain`` boxes of 24 x 40 px 6 px apart
    (``chain_boxes``: eight waves deep) whose scores fall along it, the
    clusters apart on a grid of the 1280 x 720 frame with seeded offsets
    and scores. Returns numpy (tlbr
    [n, 4], scores [n], valid [n]); the overlap is their DIoU at beta 0.6,
    as ``nms_and_gate`` computes it, at threshold 0.5."""
    rng = np.random.default_rng(seed)
    n_clusters = n // chain
    cols = 8
    rows = -(-n_clusters // cols)
    boxes, scores = [], []
    for c in range(n_clusters):
        x0 = (c % cols) * field[0] / cols + rng.uniform(0, 8)
        y0 = (c // cols) * field[1] / rows + rng.uniform(0, 4)
        b = chain_boxes(chain // 2, x0, y0, 24.0, 40.0, 6.0)
        b = np.concatenate([b, b[-1:] + np.array([6, 0, 6, 0], F32)])
        boxes.append(b[:chain])
        top = rng.uniform(0.6, 1.0)
        scores.append(top - 0.01 * np.arange(chain))
    order = rng.permutation(n)
    tlbr = np.concatenate(boxes)[order].astype(F32)
    score = np.concatenate(scores)[order].astype(F32)
    return tlbr, score, np.ones(n, bool)


def diou(tlbr):
    return tgeom.diou_matrix(T(tlbr), 0.6).numpy()


def suppress_case(kind, seed=0):
    """(overlap [..., N, N], scores [..., N], valid [..., N], thresh) of a
    kind of case, numpy."""
    rng = np.random.default_rng(seed)
    if kind == 'ties':
        b = random_boxes(rng, 64, (200.0, 150.0))
        s = np.round(rng.uniform(0, 1, 64) * 4) / 4
        return (tgeom.bbox_ious(T(b), T(b)).numpy(), s.astype(F32),
                rng.uniform(size=64) < 0.9, 0.3)
    if kind == 'chains':
        boxes = [chain_boxes(d, 200.0 * d, 50.0) for d in CHAIN_DEPTHS]
        b = np.concatenate(boxes + [random_boxes(rng, 70 - 36,
                                                 size=(5, 10))])
        s = np.concatenate([0.95 - 0.02 * np.arange(len(x)) for x in boxes]
                           + [rng.uniform(0, 0.5, 70 - 36)]).astype(F32)
        perm = rng.permutation(len(b))
        return diou(b[perm]), s[perm], np.ones(len(b), bool), 0.5
    if kind == 'invalid':
        b = random_boxes(rng, 50)
        return (tgeom.bbox_ious(T(b), T(b)).numpy(),
                rng.uniform(0, 1, 50).astype(F32), np.zeros(50, bool), 0.5)
    if kind == 'odd':
        b = random_boxes(rng, 33, (100.0, 100.0))
        return (tgeom.bbox_ious(T(b), T(b)).numpy(),
                rng.uniform(0, 1, 33).astype(F32),
                rng.uniform(size=33) < 0.8, 0.4)
    if kind == 'batched':
        b = np.stack([random_boxes(rng, 96, (300.0, 200.0))
                      for _ in range(8)])
        return (tgeom.bbox_ious(T(b), T(b)).numpy(),
                np.round(rng.uniform(0, 1, (8, 96)), 2).astype(F32),
                rng.uniform(size=(8, 96)) < 0.85, 0.45)
    if kind == 'cross_label':
        b = random_boxes(rng, 128, (300.0, 200.0))
        lab = rng.integers(0, 3, 128)
        ov = np.where(lab[:, None] == lab[None, :], diou(b),
                      -np.inf).astype(F32)
        return ov, rng.uniform(0.2, 1, 128).astype(F32), \
            rng.uniform(size=128) < 0.9, 0.5
    if kind == 'nan':
        b = random_boxes(rng, 40, (120.0, 120.0))
        ov = tgeom.bbox_ious(T(b), T(b)).numpy()
        ov[rng.uniform(size=ov.shape) < 0.1] = np.nan
        s = rng.uniform(0, 1, 40).astype(F32)
        s[[3, 17]] = np.nan
        return ov, s, np.ones(40, bool), 0.3
    if kind == 'contested':
        b, s, v = contested_nms(seed)
        return diou(b), s, v, 0.5
    raise ValueError(kind)


def merge_case(kind, seed=0):
    """(edge [..., N, N] bool, valid [..., N]) of a kind of case, numpy."""
    rng = np.random.default_rng(seed)

    def chains(n, length):
        edge = np.zeros((n, n), bool)
        perm = rng.permutation(n)
        for s in range(0, n - length + 1, length):
            p = perm[s:s + length]
            edge[p[:-1], p[1:]] = True
        return edge | edge.T
    if kind == 'chains':
        return chains(96, 8), np.ones(96, bool)
    if kind == 'stars':
        edge = np.zeros((64, 64), bool)
        for hub in range(0, 64, 16):
            edge[hub, hub + 1:hub + 16] = True
        edge |= edge.T
        return edge, rng.uniform(size=64) < 0.9
    if kind == 'invalid':
        return np.zeros((40, 40), bool), np.zeros(40, bool)
    if kind == 'odd':
        e = rng.uniform(size=(45, 45)) < 0.03
        return e | e.T, rng.uniform(size=45) < 0.8
    if kind == 'batched':
        return np.stack([chains(64, 5) for _ in range(3)]), \
            rng.uniform(size=(3, 64)) < 0.9
    if kind == 'ssd':
        return contested_merge(seed)
    raise ValueError(kind)


def contested_merge(seed=0, n_tiles=8, topk=100):
    """chip_smoke.py phase 20's contested merge at the SSD's full width (8
    tiles x TOPK 100 rows, 80 of a tile's valid): components that are
    chains of one row a tile across the 8 tiles (7 propagation rounds)
    shuffled over the rows, cut where a row is invalid (the SSD links
    valid rows only), and single rows. Returns numpy (edge [800, 800], valid [800])."""
    rng = np.random.default_rng(seed)
    n = n_tiles * topk
    edge = np.zeros((n, n), bool)
    rows = [rng.permutation(topk) for _ in range(n_tiles)]
    for c in range(60):
        members = [t * topk + rows[t][c] for t in range(n_tiles)]
        for a, b in zip(members[:-1], members[1:]):
            edge[a, b] = edge[b, a] = True
    valid = np.arange(n) % topk < 80
    return edge & valid[:, None] & valid[None, :], valid


def ssd_rows(seed=42, crowded=False):
    """SSD decoded rows (4 tiles of 300 x 300 over a 525 x 525 region, 20
    rows a tile: [0, label, conf, x1, y1, x2, y2] in the tile's unit
    coordinates) of boxes around the tiles' shared strips, labels 1 and 2:
    same-tile and cross-tile duplicates; ``crowded`` puts every tile's
    boxes within a few pixels of one another, so components span the
    tiles. Returns numpy (det_out, tiles, scale, label_mask) as
    ``SSDDetector._postprocess_device`` takes them."""
    rng = np.random.default_rng(seed)
    n_tiles, topk = 4, 20
    tiles = np.array([[0, 0, 299, 299], [225, 0, 524, 299],
                      [0, 225, 299, 524], [225, 225, 524, 524]], F32)
    centers = rng.uniform(200, 320, (topk, 2))
    det_out = np.zeros((n_tiles, topk, 7), F32)
    for t, tile in enumerate(tiles):
        c = centers + rng.normal(0, 3 if crowded else 40, (topk, 2))
        wh = rng.uniform(20, 60, (topk, 2))
        size = tile[2:] - tile[:2] + 1
        tl = (c - wh / 2 - tile[:2]) / size
        br = (c + wh / 2 - tile[:2]) / size
        conf = np.sort(rng.uniform(0.3, 1, topk))[::-1]
        label = rng.choice([1, 1, 1, 2], topk)
        det_out[t] = np.concatenate([np.zeros((topk, 1)), label[:, None],
                                     conf[:, None], tl, br], 1)
    label_mask = np.zeros(91, bool)
    label_mask[[1, 2]] = True
    return det_out, tiles, np.array([1.5, 1.2], F32), label_mask


def plain_waves(overlap, scores, valid, thresh):
    """The plain version's wave count (its loop, counted)."""
    n = scores.shape[-1]
    idx = torch.arange(n)
    over = (overlap > thresh) & (idx[:, None] != idx[None, :])
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    dom = (s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :]))
    remaining, waves = valid.clone(), 0
    while bool(remaining.any()):
        dominated = torch.any(over & dom & remaining[..., :, None], dim=-2)
        wave = remaining & ~dominated
        remaining = remaining & ~wave & ~torch.any(
            over & wave[..., :, None], dim=-2)
        waves += 1
    return waves


def output_sha256(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


# every seeded case's output as the first design of the kernels gave it
# (the plain versions' too): suppress cases at seed 1, merge cases at 2
OUTPUT_SHA256 = {
    ('merge', 'batched'):
        '6aeeb15d7d023006ce77b83bf5bb9455d94e1602cdcfff1247545affdcd1dd0f',
    ('merge', 'chains'):
        '12f17276162774f22a39b8186fd5fd14d9dc6c199f90e660e126b1072816254c',
    ('merge', 'invalid'):
        'f3544b31f9c01243874887f99a99aeba98cc4784b6edb52efcafa377ccac480e',
    ('merge', 'odd'):
        '17bd0c7d251479fed647535cdb6a35d540bf7a3724b0fd891d39acef4adf7029',
    ('merge', 'ssd'):
        '43e1aa869de7ecaceed17e23d70fb3b13623e8c9e84dff5743bf535a4c766f33',
    ('merge', 'stars'):
        '2368d416fb2ebb1f3e35527181748dcb13db14238595ee2de177b4260202727e',
    ('suppress', 'batched'):
        '4e5058e9ec5f7c7525b0ad1fc562053c144cf6c972668fd517af5e87af6856ce',
    ('suppress', 'chains'):
        '4d3023e2ef36e821f5d275ade514adc852d1a5a1088403042f75314849d353df',
    ('suppress', 'contested'):
        '182880f64fa25aae6e0b3e44a793dca94d649384ef97c2465010645cdb60240e',
    ('suppress', 'cross_label'):
        '7cd5f947edfca29736cfd023fcf203150b7b358676d02170fbc2d0e4607c696a',
    ('suppress', 'invalid'):
        'cc2786e1f9910a9d811400edcddaf7075195f7a16b216dcbefba3bc7c4f2ae51',
    ('suppress', 'nan'):
        'edfcfb98680bb0c3686d2bca013e1d4eed39a28d1f2582aea5f3dcd2f370fb3b',
    ('suppress', 'odd'):
        '637b3085a97bc8f4ec9f8239e2beea49e29fb0056896750533b571f056a2ec1f',
    ('suppress', 'ties'):
        '8c055510b0bb7e1b6f8605d704d5bb6d68ea552d201f3cd43656eee6e9a0e9a9',
}


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    return nw.declare(build_host('nms_waves', tmp_path_factory, launches=2))


def host_suppress(lib, overlap, scores, valid, thresh, threads=32):
    """``greedy_suppress`` through the host build (or, ``threads`` None,
    the card's library on CUDA tensors)."""
    if threads is not None:
        lib.set_host_threads(threads)
    keep, args, _ = nw.suppress_launch_args(overlap, scores, valid, thresh)
    assert lib.greedy_suppress_forward(*args) == 0
    return keep


def host_merge(lib, edge, valid, threads=32):
    if threads is not None:
        lib.set_host_threads(threads)
    labels, args, _ = nw.merge_launch_args(edge, valid)
    assert lib.merge_labels_forward(*args) == 0
    return labels


def torch_case(case):
    return tuple(T(a) if isinstance(a, np.ndarray) else a for a in case)


def case_outputs(lib, key, threads=32, device='cpu'):
    """The output of a seeded case through ``lib``."""
    kind, name = key
    if kind == 'suppress':
        ov, s, v, th = torch_case(suppress_case(name, seed=1))
        return host_suppress(lib, ov.to(device), s.to(device), v.to(device),
                             th, threads)
    e, v = torch_case(merge_case(name, seed=2))
    return host_merge(lib, e.to(device), v.to(device), threads)


def test_cases_are_what_they_say():
    """The chains take six waves, the contested case eight over 1,024
    boxes, and the plain keeps boxes in each kind but 'invalid'; the SSD
    merge case takes seven rounds."""
    for kind in SUPPRESS_KINDS:
        ov, s, v, th = torch_case(suppress_case(kind, seed=1))
        keep = tgeom.greedy_suppress_reference(ov, s, v, th)
        assert (int(keep.sum()) == 0) == (kind == 'invalid'), kind
        if kind in ('chains', 'contested'):
            assert plain_waves(ov, s, v, th) == (6 if kind == 'chains' else 8)
    ov, s, v, th = torch_case(suppress_case('cross_label', seed=1))
    assert bool(torch.isinf(ov).any())
    e, v = torch_case(merge_case('ssd', seed=2))
    lbl = nw.merge_labels_reference(e, v)
    assert e.shape == (800, 800) and len(torch.unique(lbl[v])) < int(v.sum())


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in SUPPRESS_KINDS]
                         + [('batched', 64), ('chains', 96),
                            ('contested', 64)])
def test_host_suppress_equals_plain_version(host_kernel, kind, threads):
    ov, s, v, th = torch_case(suppress_case(kind, seed=1))
    got = host_suppress(host_kernel, ov, s, v, th, threads)
    assert torch.equal(got, tgeom.greedy_suppress_reference(ov, s, v, th))


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in MERGE_KINDS]
                         + [('ssd', 96), ('odd', 64)])
def test_host_merge_equals_plain_version(host_kernel, kind, threads):
    e, v = torch_case(merge_case(kind, seed=2))
    got = host_merge(host_kernel, e, v, threads)
    assert torch.equal(got, nw.merge_labels_reference(e, v))


@pytest.mark.parametrize('key', sorted(
    [('suppress', k) for k in SUPPRESS_KINDS]
    + [('merge', k) for k in MERGE_KINDS]), ids=lambda k: '-'.join(k))
def test_host_outputs_equal_the_first_design(host_kernel, key):
    assert output_sha256(case_outputs(host_kernel, key)) \
        == OUTPUT_SHA256[key]


def test_plain_and_host_match_jax(host_kernel):
    """``greedy_suppress_reference`` and the host build against the JAX
    package's ``_greedy_suppress`` (``jax.vmap`` over a batch): every keep
    bit equal."""
    import jax
    import jax.numpy as jnp
    from fastmot_tpu.ops import geometry as jgeom
    for kind in SUPPRESS_KINDS:
        ov, s, v, th = suppress_case(kind, seed=3)
        fn = lambda o, sc, va: jgeom._greedy_suppress(o, sc, va, th)  # noqa
        for _ in range(ov.ndim - 2):
            fn = jax.vmap(fn)
        want = np.asarray(fn(jnp.asarray(ov), jnp.asarray(s),
                             jnp.asarray(v)))
        plain = tgeom.greedy_suppress_reference(T(ov), T(s), T(v), th)
        host = host_suppress(host_kernel, T(ov), T(s), T(v), th)
        np.testing.assert_array_equal(plain.numpy(), want, err_msg=kind)
        np.testing.assert_array_equal(host.numpy(), want, err_msg=kind)


def routed_to(monkeypatch, lib, threads=32):
    """``greedy_suppress`` and ``merge_labels`` through the host build."""
    monkeypatch.setattr(tgeom, 'greedy_suppress', lambda *a: host_suppress(
        lib, *a, threads=threads))
    monkeypatch.setattr(nw, 'merge_labels', lambda e, v: host_merge(
        lib, e, v, threads))


def test_ssd_postprocess_host_build_matches_jax(host_kernel, monkeypatch):
    """The SSD postprocess (per-tile NMS and the merge) through the host
    build on sparse and crowded decoded rows (``ssd_rows``) equals the
    plain run and the JAX package's ``SSDDetector._postprocess_device``."""
    import jax
    import jax.numpy as jnp
    from fastmot_tpu import detector as jdet
    args = (0.5, 120000, 0.6, 0.5)
    for seed, crowded in ((42, False), (43, True)):
        arrays = ssd_rows(seed, crowded)
        inputs = tuple(T(a) for a in arrays)
        plain = tdet.SSDDetector._postprocess_device(*inputs, *args)
        with monkeypatch.context() as m:
            routed_to(m, host_kernel)
            host = tdet.SSDDetector._postprocess_device(*inputs, *args)
        want = jax.jit(jdet.SSDDetector._postprocess_device,
                       static_argnums=(4, 5, 6, 7))(
            *(jnp.asarray(a) for a in arrays), *args)
        for p, h, w in zip(plain, host, want):
            np.testing.assert_array_equal(h.numpy(), p.numpy())
            np.testing.assert_array_equal(h.numpy(), np.asarray(w))
        assert int(plain[3].sum()) > 3


def test_nms_and_gate_host_build_equals_plain(host_kernel, monkeypatch):
    """``nms_and_gate`` on two streams of clustered, tied, two-label
    candidates ([S, N, 7]: one NMS call for both) through the host build
    equals its plain run, every output."""
    rng = np.random.default_rng(7)
    n = 300
    rows = []
    for _ in range(2):
        centers = rng.uniform(0.1, 0.9, (10, 2))
        xy = centers[rng.integers(0, 10, n)] + rng.normal(0, 0.01, (n, 2))
        wh = rng.uniform(0.05, 0.2, (n, 2)) * np.array([1.0, 2.0])
        rows.append(np.concatenate(
            [xy - wh / 2, wh, np.round(rng.uniform(0.2, 1.0, (n, 1)), 1),
             rng.integers(0, 2, (n, 1)),
             np.round(rng.uniform(0.5, 1, (n, 1)), 1)], 1))
    det_out = T(np.stack(rows).astype(F32))
    args = (T(np.array([True, True])), 0.25, 0.5, 800000, 1.2,
            T(np.array([640, 480, 640, 480], F32)), T(np.zeros(2, F32)))
    plain = tdet.nms_and_gate(det_out, *args)
    with monkeypatch.context() as m:
        routed_to(m, host_kernel)
        host = tdet.nms_and_gate(det_out, *args)
    for p, h in zip(plain, host):
        assert torch.equal(p, h)
    assert 5 < int(plain[3].sum()) < 150


def test_profiler_marks_are_in_the_sources():
    """scripts/prof_assoc_tail.py's stamps each find their text once in
    csrc/nms_waves.cu and csrc/assoc_commit.cu (the stamped build raises
    otherwise), and none lands between a pragma and its loop."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        'prof_assoc_tail', root / 'scripts' / 'prof_assoc_tail.py')
    prof = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:                   # the script puts its folders on the path
        spec.loader.exec_module(prof)
    finally:
        sys.path[:] = path
    for name, marks in (('nms_waves', prof.NMS_MARKS),
                        ('assoc_commit', prof.COMMIT_MARKS)):
        src = (root / 'fastmot_tpu_torch' / 'csrc' / f'{name}.cu').read_text()
        for mark, text in marks:
            plain = text.replace('@', '')
            assert src.count(plain) == 1, (name, mark)
            at = src.index(plain) + text.index('@')
            assert not src[:at].rstrip().split('\n')[-1].startswith(
                '#pragma'), (name, mark)


def test_wrappers_on_cpu_are_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers call the plain versions and count no
    launch."""
    ov, s, v, th = torch_case(suppress_case('odd', seed=1))
    e, ev = torch_case(merge_case('odd', seed=2))
    before = tgeom.greedy_suppress.launches, nw.merge_labels.launches
    monkeypatch.setattr(nw, 'nms_waves_library', lambda: pytest.fail(
        'the kernel library was loaded for CPU tensors'))
    assert torch.equal(tgeom.greedy_suppress(ov, s, v, th),
                       tgeom.greedy_suppress_reference(ov, s, v, th))
    assert torch.equal(nw.merge_labels(e, ev),
                       nw.merge_labels_reference(e, ev))
    assert (tgeom.greedy_suppress.launches, nw.merge_labels.launches) \
        == before


def test_wrappers_raise_on_other_devices():
    ov = torch.zeros((4, 4), device='meta')
    v = torch.zeros(4, dtype=torch.bool, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tgeom.greedy_suppress(ov, torch.zeros(4, device='meta'), v, 0.5)
    with pytest.raises(ValueError, match='unsupported device'):
        nw.merge_labels(torch.zeros((4, 4), dtype=torch.bool,
                                    device='meta'), v)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'size', 'valid'])
def test_suppress_launch_args_raise_on_each_fault(fault):
    n = 1025 if fault == 'size' else 40
    ov = torch.zeros((2, n, n), dtype=torch.float64 if fault == 'dtype'
                     else torch.float32)
    s = torch.zeros((2, n + (fault == 'shape')))
    v = torch.zeros((2, n), dtype=torch.int32 if fault == 'valid'
                    else torch.bool)
    with pytest.raises(ValueError, match='nms_waves'):
        nw.suppress_launch_args(ov, s, v, 0.5)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'size'])
def test_merge_launch_args_raise_on_each_fault(fault):
    n = 1025 if fault == 'size' else 30
    e = torch.zeros((n, n), dtype=torch.float32 if fault == 'dtype'
                    else torch.bool)
    v = torch.zeros(n - (fault == 'shape'), dtype=torch.bool)
    with pytest.raises(ValueError, match='nms_waves'):
        nw.merge_launch_args(e, v)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', SUPPRESS_KINDS)
def test_kernel_suppress_matches_plain_version(cuda, kind):
    ov, s, v, th = torch_case(suppress_case(kind, seed=1))
    before = tgeom.greedy_suppress.launches
    got = tgeom.greedy_suppress(ov.to(cuda), s.to(cuda), v.to(cuda), th)
    torch.cuda.synchronize()
    assert tgeom.greedy_suppress.launches == before + 1
    assert torch.equal(got.cpu(),
                       tgeom.greedy_suppress_reference(ov, s, v, th))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', MERGE_KINDS)
def test_kernel_merge_matches_plain_version(cuda, kind):
    e, v = torch_case(merge_case(kind, seed=2))
    before = nw.merge_labels.launches
    got = nw.merge_labels(e.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert nw.merge_labels.launches == before + 1
    assert torch.equal(got.cpu(), nw.merge_labels_reference(e, v))


@pytest.mark.cuda
def test_kernel_outputs_equal_the_first_design(cuda):
    lib = nw.nms_waves_library()
    for key in OUTPUT_SHA256:
        assert output_sha256(case_outputs(lib, key, None, cuda)) \
            == OUTPUT_SHA256[key], key


@pytest.mark.cuda
def test_kernels_run_without_a_host_sync(cuda):
    """``nms_and_gate`` and the SSD postprocess on the card under
    ``torch.cuda.set_sync_debug_mode('error')``, equal to the CPU run."""
    rng = np.random.default_rng(5)
    det_out = np.concatenate([rng.uniform(0, 1, (400, 4)),
                              rng.uniform(0.2, 1, (400, 1)),
                              rng.integers(0, 2, (400, 1)),
                              rng.uniform(0.5, 1, (400, 1))], 1).astype(F32)
    args = (0.25, 0.5, 800000, 1.2)
    yolo = (T(det_out), T(np.array([True, True])), *args,
            T(np.array([640, 480, 640, 480], F32)), T(np.zeros(2, F32)))
    ssd = tuple(T(a) for a in ssd_rows(43, crowded=True))
    ssd_args = (0.5, 120000, 0.6, 0.5)
    want = (tdet.nms_and_gate(*yolo),
            tdet.SSDDetector._postprocess_device(*ssd, *ssd_args))
    on_card = [tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a
                     for a in x) for x in (yolo, ssd)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = (tdet.nms_and_gate(*on_card[0]),
               tdet.SSDDetector._postprocess_device(*on_card[1], *ssd_args))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, want):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w))
