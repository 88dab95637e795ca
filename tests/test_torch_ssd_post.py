"""The SSD postprocess kernels of the port (``csrc/nms_waves.cu``'s
``ssd_postprocess_forward``, wrapper ``ops.nms_waves.ssd_postprocess``
behind ``SSDDetector._postprocess_device`` on the card, plain version
``detector.ssd_postprocess_reference``): the pixel boxes and gates, the
per-tile class-aware NMS and the cross-tile IoM merge, computed from the
decoded rows in two launches with no [n, n] matrix.

On the CPU the kernels' own source is built for the host with g++ through
tests/cuda_host_shim.py (a launch's blocks in turn on a team of host
threads; the kernels stride their loops by the block's thread count and
take whole warps, so teams of 32, 64 and 96 threads compute what 1,024
do). Each build equals the plain version bit for bit, every output, on
seeded cases (``KINDS``); every output of every case is, to the bit, what
the plain version gave when the kernels were written (``OUTPUT_SHA256``);
the sparse and crowded cases equal the JAX package's jitted
``SSDDetector._postprocess_device``.

On the card (marker ``cuda``; they skip without one):

    python -m pytest tests/test_torch_ssd_post.py -m cuda
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
# the 4 x 2 grid of 300 x 300 tiles at a 0.25 overlap (cfg/mot.json's
# ssd_detector_cfg) over its 975 x 525 region, for a 1280 x 720 frame
GRID, TILE, STEP, REGION = (4, 2), 300, 225, (975, 525)
FRAME = (1280, 720)
TOPK = 100
NUM_CLASSES = 91
SCALARS = (0.5, 120000, 0.6, 0.5)   # conf, max_area, merge, nms thresholds


def grid_tiles():
    """(tiles [8, 4] tlbr in region pixels, scale [2]) as
    ``SSDDetector`` makes them for cfg/mot.json's grid at 1280 x 720."""
    tiles = np.array([[c * STEP, r * STEP, c * STEP + TILE - 1,
                       r * STEP + TILE - 1]
                      for r in range(GRID[1]) for c in range(GRID[0])], F32)
    return tiles, (np.array(FRAME) / np.array(REGION)).astype(F32)


def rows_of(tile, boxes, labels, confs):
    """Decoded rows [k, 7] (``[0, label, conf, x1, y1, x2, y2]`` in the
    tile's unit coordinates) of boxes given in region pixels."""
    size = tile[2:] - tile[:2] + 1
    unit = (boxes.reshape(-1, 2, 2) - tile[:2]) / size
    return np.concatenate([np.zeros((len(boxes), 1)), labels[:, None],
                           confs[:, None], unit.reshape(-1, 4)], 1)


def chain_boxes(depth, x0, y0, width=40.0, height=80.0, step=10.0):
    """A chain of 2 * depth - 1 boxes along x, each overlapping its
    neighbours at IoU 0.6 and the boxes two apart at 0.33: with confs
    falling along it, the greedy NMS keeps every other box, one a wave."""
    n = 2 * depth - 1
    x = x0 + step * np.arange(n)
    return np.stack([x, np.full(n, y0), x + width - 1,
                     np.full(n, y0 + height - 1)], -1)


def crowded_rows(seed=0):
    """The crowded full-width case: 8 tiles x 100 rows. Each tile holds a
    row of each of 8 cross-tile components (60 x 50 px boxes sliding 18 px
    a tile, IoM 0.7 to the next tile's and 0.4 to the one after: chains
    across all 8 tiles), five same-label chains 2 to 6 waves deep (shifted
    30 px a tile, so the kept boxes merge across tiles too), a box over
    ``max_area`` and random boxes of labels in and out of the mask, with
    confs on either side of the threshold; each tile's rows in falling
    conf, as ``decode_ssd`` gives them. Returns numpy (det_out [8, 100,
    7], tiles, scale, label_mask) as ``SSDDetector._postprocess_device``
    takes them."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    det_out = np.zeros((len(tiles), TOPK, 7), F32)
    for t, tile in enumerate(tiles):
        boxes, labels, confs = [], [], []
        for c in range(8):
            x, y = 100 + 18 * t + rng.uniform(0, 2), 10 + 64 * c
            boxes.append([[x, y, x + 59, y + 49]])
            labels.append([1 + (c % 3 == 2)])
            confs.append([rng.uniform(0.6, 1.0)])
        for k, depth in enumerate(range(2, 7)):
            b = chain_boxes(depth, 400 + 30 * t, 20 + 100 * k)
            boxes.append(b)
            labels.append(np.full(len(b), 1 + k % 2))
            confs.append(0.95 - 0.02 * np.arange(len(b)))
        big = rng.uniform(0, 200, 2)
        boxes.append([[*big, big[0] + 299, big[1] + 319]])
        labels.append([1])
        confs.append([0.99])
        n = TOPK - sum(len(b) for b in boxes)
        xy = rng.uniform(2, (REGION[0] - 70, REGION[1] - 70), (n, 2))
        wh = rng.uniform(15, 60, (n, 2))
        boxes.append(np.concatenate([xy, xy + wh], 1))
        labels.append(rng.choice([1, 1, 1, 2, 2, 3], n))
        confs.append(rng.uniform(0.3, 1.0, n))
        boxes, labels, confs = (np.concatenate([np.asarray(a, float)
                                                for a in x])
                                for x in (boxes, labels, confs))
        order = np.argsort(-confs, kind='stable')
        det_out[t] = rows_of(tile, boxes[order], labels[order],
                             confs[order])
    mask = np.zeros(NUM_CLASSES, bool)
    mask[[1, 2]] = True
    return det_out, tiles, scale, mask


def sparse_rows(seed=0):
    """The sparse full-width case: a scene of 12 objects of labels 1 to 3,
    each seen by every tile its centre falls in (a few pixels off from
    tile to tile, so the tiles' strips give cross-tile duplicates) and
    twice by each (a second box 4 px off at a lower conf, which the NMS
    suppresses), the rest of a tile's 100 rows random boxes below the conf
    threshold; each tile's rows in falling conf. Returns numpy as
    ``crowded_rows``."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    centre = rng.uniform((40, 40), (REGION[0] - 40, REGION[1] - 40), (12, 2))
    half = rng.uniform(15, 40, (12, 2))
    label = rng.choice([1, 1, 2, 3], 12)
    det_out = np.zeros((len(tiles), TOPK, 7), F32)
    for t, tile in enumerate(tiles):
        seen = np.nonzero(np.all((centre >= tile[:2])
                                 & (centre <= tile[2:]), 1))[0]
        c = centre[seen] + rng.normal(0, 2, (len(seen), 2))
        box = np.concatenate([c - half[seen], c + half[seen]], 1)
        conf = rng.uniform(0.6, 1.0, len(seen))
        n = TOPK - 2 * len(seen)
        xy = tile[:2] + rng.uniform(0, 240, (n, 2))
        boxes = np.concatenate([box, box + 4, np.concatenate(
            [xy, xy + rng.uniform(20, 120, (n, 2))], 1)])
        labels = np.concatenate([label[seen], label[seen],
                                 rng.choice([1, 1, 2, 3], n)])
        confs = np.concatenate([conf, conf - 0.1,
                                rng.uniform(0.0, 0.45, n)])
        order = np.argsort(-confs, kind='stable')
        det_out[t] = rows_of(tile, boxes[order], labels[order],
                             confs[order])
    mask = np.zeros(NUM_CLASSES, bool)
    mask[[1, 2]] = True
    return det_out, tiles, scale, mask


def tied_rows(seed=0):
    """3 tiles x 40 rows clustered around 6 centres, confs on 4 values
    (ties everywhere in the greedy order), labels 1 and 2."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    det_out = np.zeros((3, 40, 7), F32)
    centre = rng.uniform(80, 220, (6, 2))
    for t in range(3):
        c = centre[rng.integers(0, 6, 40)] + rng.normal(0, 4, (40, 2))
        half = rng.uniform(20, 30, (40, 2))
        det_out[t] = rows_of(tiles[t], np.concatenate([c - half, c + half], 1)
                             + tiles[t, :2].repeat(2),
                             rng.choice([1, 2], 40),
                             rng.choice([0.6, 0.7, 0.8, 0.9], 40))
    mask = np.zeros(NUM_CLASSES, bool)
    mask[[1, 2]] = True
    return det_out, tiles[:3], scale, mask


def nan_inf_rows(seed=0):
    """2 tiles x 50 rows: NaN and infinite confs and coordinates among
    overlapping boxes (a NaN or infinite box fails the area gate; an
    infinite conf passes and comes first), a box 1e30 px out whose corners
    round to themselves, and coordinates that overflow to infinity."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    det_out = np.zeros((2, 50, 7), F32)
    for t in range(2):
        c = rng.uniform(100, 200, (50, 2))
        half = rng.uniform(20, 40, (50, 2))
        det_out[t] = rows_of(tiles[t], np.concatenate([c - half, c + half], 1)
                             + tiles[t, :2].repeat(2),
                             rng.choice([1, 2], 50),
                             rng.uniform(0.4, 1.0, 50))
    det_out[0, [3, 11], 2] = np.nan
    det_out[0, [5, 17], 2] = np.inf
    det_out[1, 8, 2] = -np.inf
    det_out[0, 20, 3] = np.nan
    det_out[1, [4, 9], 5] = np.inf
    det_out[1, 12, 3] = -np.inf
    det_out[0, 25, 3:7] = [1e30, 1e30, 1e30 + 1e24, 1e30 + 1e24]
    det_out[1, 30, 3:7] = [0.1, 0.1, 3e38, 0.5]
    det_out[:, :, 2] = np.where(det_out[:, :, 2] == 0, 0.9,
                                det_out[:, :, 2])
    mask = np.zeros(NUM_CLASSES, bool)
    mask[[1, 2]] = True
    return det_out, tiles[:2], scale, mask


def signed_zero_rows():
    """2 tiles x 6 rows at a conf threshold of 0: confs of -0.0 and +0.0
    (both pass), and boxes whose corners round to -0.0 or +0.0 in pixels,
    merged across the two tiles with the -0.0 member first in one
    component and the +0.0 member first in the other."""
    tiles = np.array([[0, 0, 299, 299], [0, 0, 299, 299]], F32)
    scale = np.ones(2, F32)
    neg, pos = -0.3 / 300, 0.0
    det_out = np.zeros((2, 6, 7), F32)
    # [label, conf, x1, y1, x2, y2] in unit coordinates
    det_out[0, :, 1:] = [[1, -0.0, neg, neg, 0.2, 0.3],
                         [1, 0.0, 0.5, pos, 0.7, 0.2],
                         [2, -0.0, 0.4, 0.4, 0.6, 0.6],
                         [2, 0.3, 0.8, 0.8, 0.9, 0.9],
                         [1, -0.0, 0.1, 0.6, 0.3, 0.8],
                         [1, 0.0, 0.12, 0.61, 0.31, 0.8]]
    det_out[1, :, 1:] = [[1, 0.0, pos, pos, 0.2, 0.3],
                         [1, -0.0, 0.5, neg, 0.7, 0.2],
                         [2, 0.0, 0.4, 0.4, 0.6, 0.6],
                         [2, -0.0, 0.8, 0.8, 0.9, 0.9],
                         [1, 0.0, 0.1, 0.6, 0.3, 0.8],
                         [1, -0.0, 0.6, 0.6, 0.7, 0.7]]
    return det_out, tiles, scale, np.ones(3, bool)


def label_rows(seed=0):
    """4 tiles x 16 rows of labels outside the mask and outside its range
    (-5, 0, 95, 300, 1.9, -0.7 and the mask's own 5), through a mask of
    3 labels, so that labels clamp to both ends and negative labels come
    first in the order."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    det_out = np.zeros((4, 16, 7), F32)
    for t in range(4):
        xy = rng.uniform(0, 250, (16, 2))
        det_out[t] = rows_of(tiles[t], np.concatenate(
            [xy, xy + rng.uniform(20, 50, (16, 2))], 1)
            + tiles[t, :2].repeat(2),
            rng.choice([-5, 0, 1, 2, 5, 95, 300, 1.9, -0.7], 16),
            rng.uniform(0.3, 1.0, 16))
    return det_out, tiles[:4], scale, np.array([True, False, True])


def chain_rows(seed=0):
    """2 tiles x 60 rows: same-label chains 2 to 6 waves deep in each
    tile (``chain_boxes``, both labels), with random boxes around them, the
    rows in random order (not by conf)."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    det_out = np.zeros((2, 60, 7), F32)
    for t in range(2):
        boxes = [chain_boxes(d, tiles[t, 0] + 20 + 40 * (d % 2),
                             tiles[t, 1] + 50 * (d - 2)) for d in range(2, 7)]
        confs = [0.95 - 0.03 * np.arange(len(b)) for b in boxes]
        labels = [np.full(len(b), 1 + d % 2) for d, b in enumerate(boxes)]
        n = 60 - sum(len(b) for b in boxes)
        xy = tiles[t, :2] + rng.uniform(0, 260, (n, 2))
        boxes.append(np.concatenate([xy, xy + rng.uniform(5, 15, (n, 2))],
                                    1))
        confs.append(rng.uniform(0.5, 1.0, n))
        labels.append(rng.choice([1, 2], n))
        boxes, confs, labels = (np.concatenate(x)
                                for x in (boxes, confs, labels))
        order = rng.permutation(60)
        det_out[t] = rows_of(tiles[t], boxes[order], labels[order],
                             confs[order])
    mask = np.zeros(NUM_CLASSES, bool)
    mask[[1, 2]] = True
    return det_out, tiles[:2], scale, mask


def spanning_rows(seed=0):
    """8 tiles x 12 rows: four components of one row a tile across all 8
    tiles (60 x 50 px boxes sliding 18 px a tile: a chain seven edges
    long), each tile's rows shuffled."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    det_out = np.zeros((8, 12, 7), F32)
    for t in range(8):
        boxes = np.array([[100 + 18 * t, 20 + 120 * c, 159 + 18 * t,
                           69 + 120 * c] for c in range(4)], float)
        xy = rng.uniform(400, 900, (8, 2)) * [1, 0.5]
        boxes = np.concatenate([boxes, np.concatenate([xy, xy + 30], 1)])
        order = rng.permutation(12)
        det_out[t] = rows_of(tiles[t], boxes[order], np.ones(12),
                             rng.uniform(0.6, 1.0, 12)[order])
    mask = np.zeros(NUM_CLASSES, bool)
    mask[1] = True
    return det_out, tiles, scale, mask


def many_rows(seed=0):
    """8 tiles x 100 rows of 12 x 12 px boxes on distinct cells of a
    25 px grid of the region (no two overlap), labels 1 and 2: about 700
    components of one row, so MAX_DETS cuts the order."""
    rng = np.random.default_rng(seed)
    tiles, scale = grid_tiles()
    cells = rng.permutation(39 * 21)[:800]
    xy = np.stack([cells % 39, cells // 39], 1) * 25.0 + 5
    det_out = np.zeros((8, 100, 7), F32)
    for t in range(8):
        b = xy[100 * t:100 * (t + 1)]
        det_out[t] = rows_of(tiles[t], np.concatenate([b, b + 11], 1),
                             rng.choice([1, 2], 100),
                             rng.uniform(0.4, 1.0, 100))
    mask = np.zeros(NUM_CLASSES, bool)
    mask[[1, 2]] = True
    return det_out, tiles, scale, mask


def max_area_rows():
    """1 tile x 4 rows at a scale of 1: a 400 x 300 px box (area 120,000,
    max_area exactly: kept), a 401 x 300 one (cut) and two small ones."""
    tiles = np.array([[0, 0, 299, 299]], F32)
    det_out = np.zeros((1, 4, 7), F32)
    det_out[0, :, 1:] = [[1, 0.9, 0.0, 0.0, 399 / 300, 299 / 300],
                         [1, 0.8, 0.0, 0.0, 400 / 300, 299 / 300],
                         [1, 0.7, 0.1, 0.1, 0.2, 0.2],
                         [1, 0.6, 0.5, 0.5, 0.6, 0.6]]
    mask = np.zeros(NUM_CLASSES, bool)
    mask[1] = True
    return det_out, tiles, np.ones(2, F32), mask


def dense_rows():
    """8 tiles x 6 rows: six concentric boxes a tile (sides 1.5 times the
    last, IoU 0.44: the NMS keeps all), the same in every tile, so every
    pair of rows of different tiles merges (IoM 1): 1,008 edges among 48
    rows, past the merge's list of 6 n, and one component."""
    tiles, scale = grid_tiles()
    side = 10.0 * 1.5 ** np.arange(6)
    c = 400.0
    det_out = np.zeros((8, 6, 7), F32)
    for t in range(8):
        det_out[t] = rows_of(tiles[t], np.stack([c - side / 2, c - side / 2,
                                                 c + side / 2, c + side / 2],
                                                1) * [1, 0.5, 1, 0.5],
                             np.ones(6), np.linspace(0.9, 0.6, 6))
    mask = np.zeros(NUM_CLASSES, bool)
    mask[1] = True
    return det_out, tiles, scale, mask


def phase8_rows():
    """chip_smoke.py phase 8's rows (tests/test_detector.py's: 4 tiles x
    20 rows, n = 80 < MAX_DETS)."""
    from chip_smoke import synthetic_ssd_rows
    return synthetic_ssd_rows(np.random.default_rng(42))


def invalid_rows():
    """The crowded case with every conf under the threshold: no row is
    valid, and the outputs are the first 128 rows' labels."""
    det_out, *rest = crowded_rows(1)
    det_out[:, :, 2] = 0.3
    return (det_out, *rest)


# kind: (the rows, the four scalars)
CASES = {
    'crowded': (lambda: crowded_rows(0), SCALARS),
    'sparse': (lambda: sparse_rows(0), SCALARS),
    'phase8': (phase8_rows, (0.5, 120000, 0.6, 0.5)),
    'invalid': (invalid_rows, SCALARS),
    'ties': (lambda: tied_rows(0), (0.5, 120000, 0.6, 0.4)),
    'nan_inf': (lambda: nan_inf_rows(0), SCALARS),
    'signed_zero': (signed_zero_rows, (0.0, 120000, 0.6, 0.5)),
    'labels': (lambda: label_rows(0), (0.5, 120000, 0.5, 0.5)),
    'chains': (lambda: chain_rows(0), SCALARS),
    'spanning': (lambda: spanning_rows(0), SCALARS),
    'many': (lambda: many_rows(0), SCALARS),
    'max_area': (max_area_rows, SCALARS),
    'dense': (dense_rows, SCALARS),
    'merge_all': (phase8_rows, (0.5, 120000, 0.0, 0.5)),
}
KINDS = tuple(CASES)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def case(kind, device='cpu'):
    """(det_out, tiles, scale, label_mask) tensors on ``device`` and the
    scalars of a kind of case."""
    make, scalars = CASES[kind]
    return tuple(T(a).to(device) for a in make()), scalars


def plain(arrays, scalars):
    return tdet.ssd_postprocess_reference(*arrays, *scalars)


def out_count(arrays):
    return min(arrays[0].shape[0] * arrays[0].shape[1], tdet.MAX_DETS)


def host_post(lib, arrays, scalars, threads=32):
    """The SSD postprocess through the host build (or, ``threads`` None,
    the card's library on CUDA tensors)."""
    if threads is not None:
        lib.set_host_threads(threads)
    outputs, args, _ = nw.ssd_postprocess_launch_args(
        *arrays, *scalars, out_count(arrays))
    assert lib.ssd_postprocess_forward(*args) == 0
    return outputs


def bits(t):
    """A tensor's bytes, so that equal means bit for bit (-0.0 != 0.0)."""
    return t.contiguous().cpu().view(torch.uint8)


def assert_same(got, want, tag=''):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, tag
        assert torch.equal(bits(g), bits(w)), tag


def output_sha256(outputs):
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# every case's outputs as the plain version gave them when the kernels
# were written
OUTPUT_SHA256 = {
    'chains':
        'ddfeb893d4007fc8e1bf5dab072621b90adc33c050ad1180798f353387e66257',
    'crowded':
        '76a367de246c156445ee14750c035a9db1ea84a9520636031bd199790e43118d',
    'dense':
        '903825f55496cccf1e54e8efb949c43878e533b5727c2832a56eaf7c732c99f7',
    'invalid':
        'b24bad1b3eaaee6777e19cefc185f14f06afc987a978dee59132578c45599d82',
    'labels':
        'b149edf188f0cc0328a4780d07c3882fa8bcfdda0ef3ffaba2f9ac44e82e7ee6',
    'many':
        '75c500100a5857d37794ef9343e56f1d2cde927f1ca42be1c8b873b29ea75c16',
    'max_area':
        '12b9820bbdb7940b34893fdf1b1b22a2fdcea2e72cbfb73ea9f8893097abd7d2',
    'merge_all':
        'd5738a5ee187c772083573e386597fb962e21577404abb0fe5214717c3bb0b52',
    'nan_inf':
        '33a27769c2c81f7d0f4764a6d1855c2e673c24ebd76d49c64d4b2cf08ef0bc67',
    'phase8':
        'a1e2e9a3d8175a762043f3b70cb23f83da29b3ff296e7c35ce10210c7e2c2fa7',
    'signed_zero':
        '1de7b67b78070c6acba38cff34d618a64410568a8491d64dadda4cd7a001c250',
    'spanning':
        'e3f565c0ae4681a3cfba8c9a053e049bd39bf695af03ee10535c91fa6fc87cf0',
    'sparse':
        '4605dc5375cd52959f9a36e9a135749fc53e368ffed8c363dfff4e606e2229cc',
    'ties':
        '1a952f5d4022de04287c0a1829b1e9131ab9495860741fd7529212f7aa017c05',
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
    return nw.declare(build_host('nms_waves', tmp_path_factory, launches=2))


def plain_stats(arrays, scalars):
    """(rows valid before the NMS, after it, NMS waves, merge rounds, the
    most tiles a component spans, the rows kept, the merge's edges) of the
    plain version's run."""
    import tests.test_torch_nms_kernel as tn
    det_out, tiles, scale, mask = arrays
    conf_thresh, max_area, merge_thresh, nms_thresh = scalars
    t, k = det_out.shape[:2]
    n = t * k
    seen = {}
    real_suppress, real_merge = tgeom.greedy_suppress, nw.merge_labels

    def suppress(ov, sc, va, th):
        seen['valid'], seen['waves'] = int(va.sum()), tn.plain_waves(
            ov, sc, va, th)
        return real_suppress(ov, sc, va, th)

    def merge(edge, valid):
        seen['after'], seen['edges'] = int(valid.sum()), int(edge.sum()) // 2
        lbl, rounds = torch.where(valid, torch.arange(n), n), 0
        while True:
            new = torch.minimum(lbl, torch.where(edge, lbl[None, :], n)
                                .amin(1))
            rounds += 1
            if torch.equal(new, lbl):
                break
            lbl = new
        seen['rounds'] = rounds
        tiles_of = {}
        for i in torch.nonzero(valid).flatten().tolist():
            tiles_of.setdefault(int(lbl[i]), set()).add(i // k)
        seen['span'] = max((len(v) for v in tiles_of.values()), default=0)
        return real_merge(edge, valid)
    with mock.patch.object(tgeom, 'greedy_suppress', suppress), \
            mock.patch.object(nw, 'merge_labels', merge):
        out = plain(arrays, scalars)
    return (seen['valid'], seen['after'], seen['waves'], seen['rounds'],
            seen['span'], int(out[3].sum()), seen['edges'])


def test_cases_are_what_they_say():
    """Each case exercises what its name says, in the plain version's
    run."""
    stats = {kind: plain_stats(*case(kind)) for kind in KINDS}
    valid, after, waves, rounds, span, kept, _ = stats['crowded']
    assert after < valid and waves >= 6 and rounds >= 7 and span == 8
    assert kept == tdet.MAX_DETS
    valid, after, waves, rounds, span, kept, _ = stats['sparse']
    assert after < valid < 40 and span == 2 and 3 < kept < after
    valid, after, _, _, span, kept, edges = stats['dense']
    assert valid == after == 48 and edges > 6 * 48 and kept == 1
    assert stats['merge_all'][6] > stats['phase8'][6] > 0
    assert stats['phase8'][5] > 0 and case('phase8')[0][0].shape == (4, 20,
                                                                     7)
    assert stats['invalid'][0] == 0
    assert stats['ties'][1] < stats['ties'][0]
    assert 0 < stats['nan_inf'][1] and stats['signed_zero'][0] == 12
    assert stats['labels'][0] > 0
    assert stats['chains'][2] == 6
    assert stats['spanning'][4] == 8
    assert stats['many'][1] > 600 and stats['many'][5] == tdet.MAX_DETS
    assert stats['max_area'][0] == 3
    arrays, scalars = case('signed_zero')
    out = plain(arrays, scalars)
    signs = torch.signbit(out[0][out[3]]).any(1)
    assert signs.any() and not signs.all()
    assert torch.signbit(arrays[0][..., 2]).any()


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in KINDS]
                         + [('crowded', 64), ('crowded', 96),
                            ('chains', 64), ('spanning', 96),
                            ('many', 64), ('ties', 96), ('dense', 64)])
def test_host_build_equals_plain_version(host_kernel, kind, threads):
    arrays, scalars = case(kind)
    assert_same(host_post(host_kernel, arrays, scalars, threads),
                plain(arrays, scalars), kind)


@pytest.mark.parametrize('kind', KINDS)
def test_outputs_equal_the_recorded_ones(host_kernel, kind):
    arrays, scalars = case(kind)
    assert output_sha256(plain(arrays, scalars)) == OUTPUT_SHA256[kind]
    assert output_sha256(host_post(host_kernel, arrays, scalars)) \
        == OUTPUT_SHA256[kind]


@pytest.mark.parametrize('kind', ['sparse', 'crowded'])
def test_host_build_matches_jax(host_kernel, kind):
    """The host build and the plain version equal the JAX package's jitted
    ``SSDDetector._postprocess_device``, every output."""
    import jax
    import jax.numpy as jnp
    from fastmot_tpu import detector as jdet
    make, scalars = CASES[kind]
    arrays = make()
    want = jax.jit(jdet.SSDDetector._postprocess_device,
                   static_argnums=(4, 5, 6, 7))(
        *(jnp.asarray(a) for a in arrays), *scalars)
    got = host_post(host_kernel, tuple(T(a) for a in arrays), scalars)
    for g, p, w in zip(got, plain(tuple(T(a) for a in arrays), scalars),
                       want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


def test_scratch_layout_agrees(host_kernel):
    for n in (1, 80, 100, 800, 1024):
        assert host_kernel.ssd_postprocess_scratch_words(n) \
            == nw.ssd_scratch_words(n)


def test_entry_refuses_what_it_cannot_do(host_kernel):
    """The C entry returns an error, and writes nothing, on an NMS
    threshold outside [0, 1] (a negative one would suppress across tiles
    and labels in the plain version), more than 1,024 rows, or more
    outputs than rows."""
    arrays, scalars = case('phase8')
    outputs, args, _ = nw.ssd_postprocess_launch_args(*arrays, *scalars, 80)
    ptrs, ints, floats, stream = args
    assert host_kernel.ssd_postprocess_forward(
        ptrs, ints, (ctypes_floats(0.5, 120000, 0.6, -0.1)), stream) != 0
    assert host_kernel.ssd_postprocess_forward(
        ptrs, ints, (ctypes_floats(0.5, 120000, 0.6, float('nan'))),
        stream) != 0
    assert host_kernel.ssd_postprocess_forward(
        ptrs, ctypes_ints(4, 257, 91, 80), floats, stream) != 0
    assert host_kernel.ssd_postprocess_forward(
        ptrs, ctypes_ints(4, 20, 91, 81), floats, stream) != 0


def ctypes_floats(*v):
    import ctypes
    return (ctypes.c_float * len(v))(*v)


def ctypes_ints(*v):
    import ctypes
    return (ctypes.c_int * len(v))(*v)


def test_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    """On CPU tensors ``SSDDetector._postprocess_device`` is the plain
    version, loads no kernel and counts no launch."""
    arrays, scalars = case('sparse')
    before = nw.ssd_postprocess.launches
    monkeypatch.setattr(nw, 'nms_waves_library', lambda: pytest.fail(
        'the kernel library was loaded for CPU tensors'))
    assert_same(tdet.SSDDetector._postprocess_device(*arrays, *scalars),
                plain(arrays, scalars))
    assert nw.ssd_postprocess.launches == before


def test_wrapper_raises_on_other_devices():
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tdet.SSDDetector._postprocess_device(
            torch.zeros((8, 100, 7), device=meta),
            torch.zeros((8, 4), device=meta), torch.ones(2, device=meta),
            torch.ones(91, dtype=torch.bool, device=meta), *SCALARS)


@pytest.mark.parametrize('fault', ['dtype', 'rows', 'tiles', 'scale',
                                   'mask', 'device', 'size', 'out',
                                   'nms_low', 'nms_high', 'conf', 'merge',
                                   'max_area'])
def test_launch_args_raise_on_each_fault(fault):
    t, k = (11, 100) if fault == 'size' else (8, 100)
    det = torch.zeros((t, k, 6 if fault == 'rows' else 7),
                      dtype=torch.float64 if fault == 'dtype'
                      else torch.float32)
    tiles = torch.zeros((t + (fault == 'tiles'), 4))
    scale = torch.ones(4 if fault == 'scale' else 2)
    mask = torch.ones(91, dtype=torch.int32 if fault == 'mask'
                      else torch.bool)
    if fault == 'device':
        mask = mask.to('meta')
    thresh = {'nms_low': (0.5, 120000, 0.6, -0.01),
              'nms_high': (0.5, 120000, 0.6, 1.5),
              'conf': (1.2, 120000, 0.6, 0.5),
              'merge': (0.5, 120000, float('nan'), 0.5),
              'max_area': (0.5, -1.0, 0.6, 0.5)}.get(fault, SCALARS)
    out = 129 if fault == 'out' else 128
    if fault == 'out':
        det, tiles = det[:1, :128], tiles[:1]
    with pytest.raises(ValueError, match='nms_waves'):
        nw.ssd_postprocess_launch_args(det, tiles, scale, mask, *thresh, out)


def test_profiler_marks_are_in_the_sources():
    """scripts/prof_assoc_tail.py's stamps of the SSD kernels each find
    their text once in csrc/nms_waves.cu, none between a pragma and its
    loop."""
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
    src = (root / 'fastmot_tpu_torch' / 'csrc' / 'nms_waves.cu').read_text()
    for mark, text in prof.SSD_MARKS:
        plain_text = text.replace('@', '')
        assert src.count(plain_text) == 1, mark
        at = src.index(plain_text) + text.index('@')
        assert not src[:at].rstrip().split('\n')[-1].startswith('#pragma'), \
            mark


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
    """Bit for bit the plain version on the CPU and the recorded outputs,
    in one call of the kernels, with no [n, n] matrix on the card path."""
    arrays, scalars = case(kind)
    on_card = tuple(a.to(cuda) for a in arrays)
    before = nw.ssd_postprocess.launches
    with mock.patch.object(tgeom, 'bbox_ious', side_effect=AssertionError(
            'an IoU matrix was built on the card path')), \
            mock.patch.object(tgeom, 'iom_matrix', side_effect=AssertionError(
                'an IoM matrix was built on the card path')):
        got = tdet.SSDDetector._postprocess_device(*on_card, *scalars)
    torch.cuda.synchronize()
    assert nw.ssd_postprocess.launches == before + 1
    assert_same(got, plain(arrays, scalars), kind)
    assert output_sha256(got) == OUTPUT_SHA256[kind]


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(cuda):
    arrays, scalars = case('crowded', cuda)
    tdet.SSDDetector._postprocess_device(*arrays, *scalars)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = tdet.SSDDetector._postprocess_device(*arrays, *scalars)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_same(got, plain(tuple(a.cpu() for a in arrays), scalars))
