"""The port's darknet interpreter, YOLO decode, NMS and YOLODetector against
the JAX package in float32, on a small darknet cfg written here (stride-2
convs, route with concat and groups, shortcut, upsample, maxpools, two
yolo heads) with the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu import detector as jdet
from fastmot_tpu.models import darknet as jdn
from fastmot_tpu.models import registry as jreg
from fastmot_tpu.models.yolo import decode_heads as jax_decode
from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch.models import darknet as tdn
from fastmot_tpu_torch.models import registry as treg
from fastmot_tpu_torch.models.yolo import anchor_tensors, decode_heads
from fastmot_tpu_torch.weights import flax_to_state_dict

from .test_torch_osnet_block import flax_flat

ANCHORS = '10,14, 23,27, 37,58, 81,82, 135,169, 344,319'
CFG = f"""
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=3
stride=1

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=3,4,5
anchors={ANCHORS}
classes=2
num=6
scale_x_y=1.05

[route]
layers=-3

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=swish

[upsample]
stride=2

[route]
layers=-1,4

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[maxpool]
size=2
stride=1

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=0,1,2
anchors={ANCHORS}
classes=2
num=6
scale_x_y=1.1
"""


def perturb_bn(variables, seed):
    """Non-trivial BN statistics and affine terms of the bn{i} layers."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        keys = [str(getattr(k, 'key', k)) for k in path]
        if not keys[-2].startswith('bn'):
            return leaf
        lo, hi = {'mean': (-0.1, 0.1), 'var': (0.5, 1.5),
                  'scale': (0.5, 1.5), 'bias': (-0.1, 0.1)}[keys[-1]]
        return jnp.asarray(rng.uniform(lo, hi, np.shape(leaf)), jnp.float32)
    return jax.tree_util.tree_map_with_path(visit, variables)


def jax_module():
    sections = jdn.parse_cfg(CFG)
    return jdn.DarknetModule(sections=tuple(jdn._hashable(s)
                                            for s in sections),
                             dtype=jnp.float32, precision='highest')


def test_darknet_matches_jax_in_f32(rng):
    module = jax_module()
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = perturb_bn(module.init(jax.random.PRNGKey(0), x), 1)
    want = module.apply(variables, x)
    port = tdn.DarknetModule(tdn.parse_cfg(CFG)).requires_grad_(False)
    port.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize('new_coords', [False, True])
def test_decode_heads_matches_jax(rng, new_coords):
    heads = [rng.normal(0, 1, (1, 8, 8, 21)).astype(np.float32),
             rng.normal(0, 1, (1, 16, 16, 21)).astype(np.float32)]
    anchors = [[81, 82, 135, 169, 344, 319], [10, 14, 23, 27, 37, 58]]
    scales = [1.05, 1.1]
    got = decode_heads([torch.from_numpy(h) for h in heads],
                       anchor_tensors(anchors, 'cpu'), scales, (64, 64),
                       new_coords)
    want = jax_decode([jnp.asarray(h) for h in heads], anchors, scales,
                      (64, 64), new_coords)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_nms_and_gate_matches_jax(rng):
    """Clusters of overlapping boxes, two classes, tied scores."""
    n = 400
    centers = rng.uniform(0.1, 0.9, (12, 2))
    idx = rng.integers(0, 12, n)
    xy = centers[idx] + rng.normal(0, 0.01, (n, 2))
    wh = rng.uniform(0.05, 0.2, (n, 2)) * np.array([1.0, 2.0])
    obj = np.round(rng.uniform(0.2, 1.0, n), 1)             # ties
    det_out = np.concatenate([xy - wh / 2, wh, obj[:, None],
                              rng.integers(0, 2, (n, 1)),
                              np.round(rng.uniform(0.5, 1, (n, 1)), 1)],
                             1).astype(np.float32)
    label_mask = np.array([True, True])
    scale_wh = np.array([640, 480, 640, 480], np.float32)
    offset = np.zeros(2, np.float32)
    args = (0.25, 0.5, 800000, 1.2)
    got = tdet.nms_and_gate(torch.from_numpy(det_out),
                            torch.from_numpy(label_mask), *args,
                            torch.from_numpy(scale_wh),
                            torch.from_numpy(offset))
    want = jdet._nms_and_gate(jnp.asarray(det_out), jnp.asarray(label_mask),
                              *args, jnp.asarray(scale_wh),
                              jnp.asarray(offset))
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), valid)
    assert 5 < valid.sum() < 100
    np.testing.assert_array_equal(got[0].numpy()[valid],
                                  np.asarray(want[0])[valid])
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(want[1])[valid])
    np.testing.assert_allclose(got[2].numpy()[valid],
                               np.asarray(want[2])[valid], rtol=1e-6)


@pytest.fixture
def tiny_yolo():
    """A small YOLO model class registered in both packages' registries."""
    meta = dict(NUM_CLASSES=2, LETTERBOX=False, NEW_COORDS=False,
                INPUT_SHAPE=(3, 64, 64), SCALES=[1.05, 1.1],
                ANCHORS=[[81, 82, 135, 169, 344, 319],
                         [10, 14, 23, 27, 37, 58]])
    name = 'TinyTestYOLO'
    jcls = type(name, (jreg.YOLOModel,),
                dict(meta, build=classmethod(lambda cls: jax_module())))
    tcls = type(name, (treg.YOLOModel,), dict(meta, build=classmethod(
        lambda cls: tdn.DarknetModule(tdn.parse_cfg(CFG)))))
    jreg.register_yolo(jcls)
    treg.register_yolo(tcls)
    yield name
    jreg._YOLO_REGISTRY.pop(name)
    treg._YOLO_REGISTRY.pop(name)


def test_yolo_detector_matches_jax(rng, tiny_yolo):
    cfg = dict(model=tiny_yolo, conf_thresh=0.3, nms_thresh=0.5,
               max_area=800000, min_aspect_ratio=0.0)
    jd = jdet.YOLODetector((96, 80), (1,), **cfg)
    td = tdet.YOLODetector((96, 80), (1,), device='cpu', **cfg)
    td.module.load_state_dict(flax_to_state_dict(flax_flat(jd.params)))
    frame = rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
    want = jd(frame)
    got = td(torch.from_numpy(frame))
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.tlbr, want.tlbr)
    np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_allclose(got.conf, want.conf, rtol=1e-4)
    padded = (td.detect_async(torch.from_numpy(frame)),
              td.postprocess_device())[1]
    assert [tuple(t.shape) for t in padded] == \
        [(tdet.MAX_DETS, 4), (tdet.MAX_DETS,), (tdet.MAX_DETS,),
         (tdet.MAX_DETS,)]
    assert int(padded[3].sum()) == len(want)
