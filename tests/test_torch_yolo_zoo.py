"""The port's YOLO zoo (fastmot_tpu_torch/models/yolo.py) against the JAX
package: for every registered model the same constants, the same
parameter names and shapes (the port built on the ``meta`` device, the
Flax tree from ``jax.eval_shape``, so nothing is compiled) and the same
cfg metadata; a float32 forward at a small input for three of them; and
``YOLODetector`` with a letterboxed, new_coords model on non-square
frames."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu import detector as jdet
from fastmot_tpu.models import darknet as jdn
from fastmot_tpu.models import registry as jreg
from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch.models import darknet as tdn
from fastmot_tpu_torch.models import registry as treg
from fastmot_tpu_torch.weights import flax_shapes, flax_to_state_dict

from .test_torch_detector import CFG, jax_module
from .test_torch_osnet_block import flax_flat
from .test_torch_ssd import (  # noqa: F401 (autouse fixture)
    numpy_variables, one_torch_thread)

YOLO_NAMES = sorted(jreg._YOLO_REGISTRY)
CONSTANTS = ('NUM_CLASSES', 'LETTERBOX', 'NEW_COORDS', 'INPUT_SHAPE',
             'LAYER_FACTORS', 'SCALES', 'ANCHORS')


def test_zoo_registers_every_jax_yolo():
    assert sorted(treg._YOLO_REGISTRY) == YOLO_NAMES
    assert len(YOLO_NAMES) == 11


@pytest.mark.parametrize('name', YOLO_NAMES)
def test_zoo_model_matches_flax_tree(name):
    jcls = jreg.YOLOModel.get_model(name)
    tcls = treg.YOLOModel.get_model(name)
    for const in CONSTANTS:
        assert getattr(tcls, const) == getattr(jcls, const), const
    module = jcls.build()
    x = jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.float32)
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    want = {'/'.join(str(getattr(k, 'key', k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    with torch.device('meta'):
        port = tcls.build()
    assert flax_shapes(port) == want
    sections = [{'type': 'net', 'width': tcls.INPUT_SHAPE[2],
                 'height': tcls.INPUT_SHAPE[1]}, *port.layers]
    assert tdn.yolo_meta_from_cfg(sections) == \
        jdn.yolo_meta_from_cfg(module.sections)
    n_floats = tdn.count_weight_floats(port.layers)
    assert n_floats == jdn.count_weight_floats(module.sections)
    assert n_floats == sum(int(np.prod(s)) for s in want.values())


@pytest.mark.parametrize('name', ['YOLOv4Tiny', 'YOLOv3SPP', 'YOLOv4CSP'])
def test_zoo_forward_matches_jax_in_f32(name):
    """Float32 on both sides (the registered models compute in bf16), a
    64x64 input, seeded weights with non-trivial BN."""
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    module = jreg.YOLOModel.get_model(name).build().clone(
        dtype=jnp.float32, precision='highest')
    variables = numpy_variables(module, x, 2)
    want = jax.jit(module.apply)(variables, x)
    with torch.device('meta'):
        layers = treg.YOLOModel.get_model(name).build().layers
    port = tdn.DarknetModule(layers).requires_grad_(False)
    port.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    got = port(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.fixture
def letterbox_yolo():
    """A small letterboxed new_coords model in both packages' registries."""
    meta = dict(NUM_CLASSES=2, LETTERBOX=True, NEW_COORDS=True,
                INPUT_SHAPE=(3, 64, 64), SCALES=[2.0, 2.0],
                ANCHORS=[[81, 82, 135, 169, 344, 319],
                         [10, 14, 23, 27, 37, 58]])
    name = 'LetterboxTestYOLO'
    jcls = type(name, (jreg.YOLOModel,),
                dict(meta, build=classmethod(lambda cls: jax_module())))
    tcls = type(name, (treg.YOLOModel,), dict(meta, build=classmethod(
        lambda cls: tdn.DarknetModule(tdn.parse_cfg(CFG)))))
    jreg.register_yolo(jcls)
    treg.register_yolo(tcls)
    yield name
    jreg._YOLO_REGISTRY.pop(name)
    treg._YOLO_REGISTRY.pop(name)


@pytest.mark.parametrize('size', [(96, 64), (128, 96)])
def test_letterbox_detector_matches_jax(rng, letterbox_yolo, size):
    """Wide frames: the letterbox pads rows (an odd 43-row and an even
    48-row region), and the boxes are mapped back through the offset."""
    cfg = dict(model=letterbox_yolo, conf_thresh=0.3, nms_thresh=0.5,
               max_area=800000, min_aspect_ratio=0.0)
    jd = jdet.YOLODetector(size, (1,), **cfg)
    td = tdet.YOLODetector(size, (1,), device='cpu', **cfg)
    td.module.load_state_dict(flax_to_state_dict(flax_flat(jd.params)))
    frame = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    want = jd(frame)
    got = td(torch.from_numpy(frame))
    assert td._roi == jd._roi and td._roi[0] > 0
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.tlbr, want.tlbr)
    np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_allclose(got.conf, want.conf, rtol=1e-4)


STEM_CFG = """
[net]
width=32
height=32

[convolutional]
batch_normalize=1
filters=8
size=3
stride={s0}
pad=1
activation=leaky
{second}
[yolo]
mask=0
anchors=10,14
classes=1
"""
STEM_S2 = """
[convolutional]
batch_normalize=1
filters=12
size=3
stride=2
pad=1
activation=mish
"""


@pytest.mark.parametrize('s0,second,hw', [(2, '', 32), (1, STEM_S2, 32),
                                          (2, '', 33)])
def test_bf16_stem_keeps_the_f32_sum(rng, s0, second, hw):
    """The JAX package folds a darknet stem (a 3x3/2 conv, or 3x3/1 then
    3x3/2) to space-to-depth, and the folded convs keep their f32 sums
    where a plain bf16 conv rounds them; the port's stem does the same.
    On an odd input nothing is folded and both round."""
    cfg = STEM_CFG.format(s0=s0, second=second)
    sections = jdn.parse_cfg(cfg)
    module = jdn.DarknetModule(sections=tuple(jdn._hashable(s)
                                              for s in sections),
                               dtype=jnp.bfloat16)
    x = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    variables = numpy_variables(module, x, 11)
    want = np.asarray(module.apply(variables, x)[0])
    port = tdn.DarknetModule(tdn.parse_cfg(cfg), dtype=torch.bfloat16) \
        .requires_grad_(False)
    port.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    assert port.stem_layers(hw, hw) == (0 if hw % 2 else 1 + (s0 == 1))
    got = port(torch.from_numpy(x))[0].numpy()
    # f32 agreement but where an f32-level difference flips the bf16
    # rounding of the second conv's input (one bf16 ulp, 2**-8 relative):
    # rounding the stem's sums instead moves nearly every element
    scale = np.abs(want).max()
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert close.mean() > 0.99, close.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3 * scale)
