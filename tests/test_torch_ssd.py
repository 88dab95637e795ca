"""The port's SSD family (fastmot_tpu_torch/models/ssd.py, SSDDetector and
the layers they add) against the JAX package: the same numpy-seeded inputs
and weights (moved over by fastmot_tpu_torch.weights.flax_to_state_dict)
through the Flax modules and the port's. Then ``MOT`` with the SSD
detector end to end in the port."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu import detector as jdet
from fastmot_tpu.models import ssd as jssd
from fastmot_tpu.models.osnet import DepthwiseConv3x3 as FlaxDepthwise
from fastmot_tpu.ops import geometry as jgeom
from fastmot_tpu_torch import MOT
from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch.models import layers as tlayers
from fastmot_tpu_torch.models import ssd as tssd
from fastmot_tpu_torch.ops import geometry as tgeom
from fastmot_tpu_torch.weights import flax_shapes, flax_to_state_dict

from .test_detector import _ref_merge, _ref_tile_nms
from .test_torch_osnet_block import flax_flat

SSD_NAMES = ['SSDMobileNetV1', 'SSDMobileNetV2', 'SSDInceptionV2']
# bf16 through 30-70 layers: one-ulp (2**-8) roundings that differ between
# the two frameworks' conv sums propagate; measured max-rel <= 1.1e-2,
# mean-rel <= 9e-3 at this size
NET_MAX_REL, NET_MEAN_REL = 0.03, 0.02


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread for this module's tests: the tier-1 run puts six
    test workers on the cores, and torch's thread pool, oversubscribed,
    runs these small CPU ops ten times slower than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_variables(module, x, seed):
    """Seeded numpy values for every variable of a Flax module, shaped by
    ``jax.eval_shape`` (nothing is compiled): kernels N(0, 1/fan_in),
    BN scale and var in [0.5, 1.5], biases and means N(0, 0.1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], 'key', path[-1]))
        if leaf == 'kernel':
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif leaf in ('scale', 'var'):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.normal(0, 0.1, s.shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def rel_errs(got, want):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return err.max() / np.abs(want).max(), err.mean() / np.abs(want).mean()


def random_boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(-5, 80, (n, 2))        # some degenerate boxes
    return np.rint(np.concatenate([xy, xy + wh], 1)).astype(np.float32)


def test_iom_matrix_matches_jax(rng):
    boxes = random_boxes(rng, 60)
    got = tgeom.iom_matrix(torch.from_numpy(boxes)).numpy()
    want = np.asarray(jgeom.iom_matrix(jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.05 and (got == 1).any()


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('hw', [(10, 10), (9, 7)])
def test_depthwise_matches_flax(rng, stride, hw):
    """The stride-2 outputs sit where the symmetric pad puts them, and the
    per-tap bf16 rounding gives the Flax layer's bits."""
    x = rng.normal(0, 1, (2, *hw, 8)).astype(np.float32)
    module = FlaxDepthwise(stride=stride)
    variables = numpy_variables(module, x, 1)
    want = np.asarray(module.apply(variables, x).astype(jnp.float32))
    layer = tlayers.DepthwiseConv3x3(8, stride)
    layer.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    got = layer(torch.from_numpy(x)).float().detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_same_pools_match_flax(rng):
    x = rng.normal(0, 1, (2, 7, 10, 4)).astype(np.float32)
    xt = torch.from_numpy(x)
    avg = np.asarray(nn.avg_pool(x, (3, 3), (1, 1), padding='SAME'))
    got = tlayers.avg_pool_same(xt, 3, 1).numpy()
    np.testing.assert_allclose(got, avg, rtol=1e-6, atol=1e-7)
    # border: the zero padding counts in the divisor
    np.testing.assert_allclose(got[0, 0, 0], x[0, :2, :2].sum((0, 1)) / 9,
                               rtol=1e-6)
    for s in (1, 2):
        want = np.asarray(nn.max_pool(x, (3, 3), (s, s), padding='SAME'))
        np.testing.assert_array_equal(
            tlayers.max_pool_same(xt, 3, s).numpy(), want)


@pytest.mark.parametrize('name', SSD_NAMES)
def test_ssd_net_matches_flax(name):
    """Every SSD net at full width on one 128x128 crop, bf16, the same
    weights: names and shapes equal, outputs within the bf16 bounds."""
    x = np.random.default_rng(0).uniform(-1, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    module = jssd.SSDModel.get_model(name).build()
    variables = numpy_variables(module, x, 1)
    want = jax.jit(module.apply)(variables, x)
    port = tssd.SSDModel.get_model(name).build().requires_grad_(False)
    flat = flax_flat(variables)
    assert flax_shapes(port) == {k: v.shape for k, v in flat.items()}
    port.load_state_dict(flax_to_state_dict(flat))
    got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        max_rel, mean_rel = rel_errs(g.numpy(), w)
        assert max_rel < NET_MAX_REL and mean_rel < NET_MEAN_REL, \
            (max_rel, mean_rel)


def test_generate_anchors_matches_jax():
    np.testing.assert_array_equal(tssd.generate_anchors(),
                                  jssd.generate_anchors())


def test_decode_ssd_matches_jax(rng):
    """Exact ties in the best class and in the top-k keep the lower
    index in both."""
    anchors = jssd.generate_anchors()
    n = anchors.shape[0]
    locs = rng.normal(0, 1, (3, n, 4)).astype(np.float32)
    confs = rng.normal(0, 2, (3, n, 91)).astype(np.float32)
    confs[:, :, 7] = confs[:, :, 5]               # tied best classes
    confs[1, 10:40] = confs[1, 500]               # tied top-k scores
    confs[1, 500, 5] = 30.0
    confs[1, 10:40, 5] = 30.0
    got = tssd.decode_ssd(torch.from_numpy(locs), torch.from_numpy(confs),
                          torch.from_numpy(anchors), 100).numpy()
    want = np.asarray(jssd.decode_ssd(jnp.asarray(locs), jnp.asarray(confs),
                                      jnp.asarray(anchors), 100))
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-6,
                               atol=1e-7)


def synthetic_det_out(rng):
    """tests/test_detector.py's decoded rows: four tiles, cross-tile and
    same-tile duplicates, a cross-label overlap."""
    n_tiles, topk = 4, 20
    det_out = np.zeros((n_tiles, topk, 7), np.float32)
    for t in range(n_tiles):
        conf = np.sort(rng.uniform(0, 1, topk))[::-1]
        label = rng.choice([1, 1, 1, 2], topk)
        x1 = rng.uniform(0, 0.8, topk)
        y1 = rng.uniform(0, 0.8, topk)
        w = rng.uniform(0.05, 0.3, topk)
        h = rng.uniform(0.05, 0.3, topk)
        det_out[t] = np.stack([np.zeros(topk), label, conf,
                               x1, y1, x1 + w, y1 + h], -1)
    det_out[0, 0] = [0, 1, 0.95, 0.80, 0.30, 0.95, 0.55]
    det_out[1, 0] = [0, 1, 0.90, 0.05, 0.31, 0.21, 0.56]
    det_out[0, 1] = [0, 1, 0.93, 0.81, 0.31, 0.96, 0.56]
    det_out[0, 2] = [0, 1, 0.88, 0.79, 0.29, 0.94, 0.54]
    det_out[0, 3] = [0, 2, 0.87, 0.80, 0.30, 0.95, 0.55]
    det_out[3, 0] = [0, 1, 0.92, 0.10, 0.10, 0.30, 0.40]
    det_out[3, 1] = [0, 1, 0.91, 0.11, 0.12, 0.31, 0.42]
    tiles = np.array([[0, 0, 299, 299], [225, 0, 524, 299],
                      [0, 225, 299, 524], [225, 225, 524, 524]], np.float32)
    scale = np.array([1.5, 1.2], np.float32)
    label_mask = np.zeros(91, bool)
    label_mask[1] = True
    return det_out, tiles, scale, label_mask


def oracle_detections(det_out, tiles, scale, label_mask, conf_thresh,
                      max_area, merge_thresh, nms_thresh):
    """tests/test_detector.py's host oracle: filter, per-tile NMS
    (_ref_tile_nms), then the reference's DFS merge (_ref_merge)."""
    detections, tile_ids = [], []
    for ti, tile in enumerate(tiles):
        w = tile[2] - tile[0] + 1
        h = tile[3] - tile[1] + 1
        cand = []
        for row in det_out[ti]:
            label_i, conf_i = int(row[1]), float(row[2])
            if conf_i < conf_thresh or not label_mask[label_i]:
                continue
            tlbr = np.rint([(row[3] * w + tile[0]) * scale[0],
                            (row[4] * h + tile[1]) * scale[1],
                            (row[5] * w + tile[0]) * scale[0],
                            (row[6] * h + tile[1]) * scale[1]])
            area = max(tlbr[2] - tlbr[0] + 1, 0) * \
                max(tlbr[3] - tlbr[1] + 1, 0)
            if 0 < area <= max_area:
                cand.append((tlbr, label_i, conf_i))
        for k in _ref_tile_nms([c[0] for c in cand], [c[1] for c in cand],
                               [c[2] for c in cand], nms_thresh):
            detections.append(cand[k])
            tile_ids.append(ti)
    ref = np.fromiter(detections, tdet.DET_DTYPE,
                      len(detections)).view(np.recarray)
    return _ref_merge(ref, np.array(tile_ids), len(tiles), merge_thresh)


def test_ssd_postprocess_matches_jax_and_oracles(rng):
    det_out, tiles, scale, label_mask = synthetic_det_out(rng)
    args = (0.5, 120000, 0.6, 0.5)     # conf, max_area, merge, nms
    got = tdet.SSDDetector._postprocess_device(
        torch.from_numpy(det_out), torch.from_numpy(tiles),
        torch.from_numpy(scale), torch.from_numpy(label_mask), *args)
    want = jax.jit(jdet.SSDDetector._postprocess_device,
                   static_argnums=(4, 5, 6, 7))(
        jnp.asarray(det_out), jnp.asarray(tiles), jnp.asarray(scale),
        jnp.asarray(label_mask), *args)
    for g, w in zip(got, want):          # the padded tensors, exactly
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32

    tlbr, label, conf, valid = (g.numpy() for g in got)
    ref = oracle_detections(det_out, tiles, scale, label_mask, *args)
    assert sorted((tuple(tlbr[i]), int(label[i]), float(conf[i]))
                  for i in np.flatnonzero(valid)) == \
        sorted((tuple(d.tlbr), int(d.label), float(np.float32(d.conf)))
               for d in ref)
    assert 3 < valid.sum() < 40


def plant(variables):
    """Make an SSD's last scale (1x1, six anchors) fire class 1 on anchors
    0 and 5 of every tile, with regressions that shrink both to a centred
    0.25 x 0.6 box: one per tile survives the NMS."""
    def edit(path, leaf):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if name.endswith('SSDHead_0/Conv_10/kernel'):
            return np.zeros_like(leaf)
        if name.endswith('SSDHead_0/Conv_10/bias'):
            leaf = np.zeros_like(leaf)
            for a, s in ((0, 0.95), (5, np.sqrt(0.95))):
                leaf[4 * a + 2] = np.log(0.25 / s) / 0.2
                leaf[4 * a + 3] = np.log(0.6 / s) / 0.2
            return leaf
        if name.endswith('SSDHead_0/Conv_11/bias'):
            leaf = np.array(leaf)
            leaf[[1, 5 * 91 + 1]] = 30.0
        return leaf
    return jax.tree_util.tree_map_with_path(edit, variables)


@pytest.fixture(scope='module')
def ssd_pair():
    """SSDMobileNetV1 in both packages with the same planted weights."""
    cls = jssd.SSDMobileNetV1
    module = cls.build()
    variables = plant(numpy_variables(
        module, np.zeros((1, 300, 300, 3), np.float32), 3))
    cfg = dict(model='SSDMobileNetV1', tiling_grid=(2, 1), conf_thresh=0.5)
    with pytest.MonkeyPatch.context() as mp:   # no eager Flax init
        mp.setattr(cls, 'init_params', classmethod(
            lambda c, seed=0: (module, variables)))
        jd = jdet.SSDDetector((320, 240), (1,), **cfg)
    td = tdet.SSDDetector((320, 240), (1,), device='cpu', **cfg)
    td.module.load_state_dict(flax_to_state_dict(flax_flat(jd.params)))
    return jd, td


def test_ssd_detector_matches_jax(ssd_pair):
    jd, td = ssd_pair
    frame = np.random.default_rng(5).integers(0, 256, (240, 320, 3),
                                              dtype=np.uint8)
    # the tiles: JAX's resize and slices against the port's preprocess
    region = jdet._resize_bilinear_rgb(
        jnp.asarray(frame, jnp.float32)[..., ::-1], (300, 525))
    crops = np.stack([np.asarray(region)[y:y + 300, x:x + 300]
                      for x, y in td.tiles[:, :2].astype(int)]) \
        * (2.0 / 255.0) - 1.0
    x = td.preprocess(torch.from_numpy(frame))
    np.testing.assert_allclose(x.numpy(), crops, atol=2e-5, rtol=0)
    # the network on those tiles, then the whole detector
    want = jax.jit(jd.module.apply)(jd.params, crops)
    for g, w in zip(td.module(x), want):
        max_rel, mean_rel = rel_errs(g.numpy(), w)
        assert max_rel < NET_MAX_REL and mean_rel < NET_MEAN_REL, \
            (max_rel, mean_rel)
    want = jd(frame)
    got = td(torch.from_numpy(frame))
    assert len(got) == len(want) == 2       # one per tile after the NMS
    np.testing.assert_array_equal(got.tlbr, want.tlbr)
    np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_allclose(got.conf, want.conf, rtol=1e-6)


def test_mot_with_ssd_tracks_planted_boxes(ssd_pair, monkeypatch):
    """``MOT(detector_type='SSD')`` in the port: the planted detections
    become two visible tracks at their boxes, and ``step_batch`` gives
    ``step``'s snapshots."""
    jd, td = ssd_pair
    monkeypatch.setattr(tssd.SSDMobileNetV1, 'init_params', classmethod(
        lambda cls, device='cpu', seed=0: td.module))
    mot = MOT((320, 240), detector_type='SSD', detector_frame_skip=2,
              ssd_detector_cfg={'model': 'SSDMobileNetV1',
                                'tiling_grid': (2, 1)},
              feature_extractor_cfgs=({'model': 'OSNet025'},),
              tracker_cfg={'confirm_hits': 1},
              device='cpu')
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)] * 6
    runs = []
    for batched in (False, True):
        mot.reset(1 / 30.0)
        if batched:
            mot.step_batch(frames[:4])
            mot.step_batch(frames[4:])
        else:
            for frame in frames:
                mot.step(frame)
        runs.append(mot.flush_tracks())
    assert runs[0].keys() == runs[1].keys()
    for fid in runs[0]:
        a, b = runs[0][fid], runs[1][fid]
        assert [t for t, _ in a] == [t for t, _ in b]
        np.testing.assert_array_equal([x for _, x in a], [x for _, x in b])
    dets = td(torch.from_numpy(frames[0]))
    boxes = sorted(map(tuple, np.asarray([x for _, x in runs[0][5]])))
    assert len(boxes) == 2
    np.testing.assert_allclose(boxes, sorted(map(tuple, dets.tlbr)),
                               atol=2.0)
