"""The port's checkpoint importers (fastmot_tpu_torch/models/{onnx_import,
ssd_convert,darknet,protoparse,osnet_convert}.py) and its copy of eval.py
against the JAX package's: the synthetic ONNX files, TF frozen-graph
Consts and darknet ``.weights`` files of tests/test_checkpoint_import.py
and tests/test_darknet.py go through both, the results are equal (the JAX
trees carried over by flax_to_state_dict), the port's modules load them
strictly, and missing or leftover tensors raise the same errors."""
import dataclasses

import numpy as np
import pytest
import torch

from fastmot_tpu import eval as jeval
from fastmot_tpu.models import darknet as jdn
from fastmot_tpu.models import onnx_import as jonnx
from fastmot_tpu.models import osnet_convert as josc
from fastmot_tpu.models import protoparse as jproto
from fastmot_tpu.models import registry as jreg
from fastmot_tpu.models import ssd_convert as jssdc
from fastmot_tpu_torch import eval as teval
from fastmot_tpu_torch.models import darknet as tdn
from fastmot_tpu_torch.models import onnx_import as tonnx
from fastmot_tpu_torch.models import osnet_convert as tosc
from fastmot_tpu_torch.models import protoparse as tproto
from fastmot_tpu_torch.models import registry as treg
from fastmot_tpu_torch.models import ssd_convert as tssdc
from fastmot_tpu_torch.models.osnet import OSNet
from fastmot_tpu_torch.weights import flax_shapes, flax_to_state_dict

from .test_checkpoint_import import (_inception_consts, _ssd_consts,
                                     _yolo_onnx_bytes)
from .test_darknet import TINY_CFG
from .test_protoparse import (graphdef, onnx_model, onnx_tensor, tf_node,
                              tf_tensor)
from .test_torch_osnet_block import flax_flat
from .test_torch_ssd import (  # noqa: F401 (autouse fixture)
    numpy_variables, one_torch_thread)


def assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


# --- YOLO from yolo2onnx-style ONNX -----------------------------------------

@pytest.fixture(scope='module')
def tiny_zoo():
    """YOLOv4Tiny: the Flax module with seeded weights, the port's module."""
    module = jreg.YOLOModel.get_model('YOLOv4Tiny').build()
    variables = numpy_variables(module, np.zeros((1, 64, 64, 3), np.float32),
                                4)
    port = treg.YOLOModel.get_model('YOLOv4Tiny').build()
    return module, variables, port


def test_yolo_onnx_import_matches_jax(tiny_zoo, tmp_path):
    module, variables, port = tiny_zoo
    f = tmp_path / 'yolo.onnx'
    f.write_bytes(_yolo_onnx_bytes(module.sections, variables, None))
    want = jonnx.yolo_params_from_onnx(module.sections, variables, f)
    got = tonnx.yolo_params_from_onnx(port.layers, port, f)
    assert_state_dicts_equal(got, flax_to_state_dict(flax_flat(want)))
    port.load_state_dict(got)


@pytest.mark.parametrize('bad', ['drop', 'extra'])
def test_yolo_onnx_errors_match_jax(tiny_zoo, tmp_path, bad):
    module, variables, port = tiny_zoo
    if bad == 'drop':
        data = _yolo_onnx_bytes(module.sections, variables, None,
                                drop='001_convolutional_conv_weights')
        err, match = KeyError, '001_convolutional_conv_weights'
    else:
        data = _yolo_onnx_bytes(
            module.sections, variables, None,
            extra=('999_convolutional_conv_weights',
                   np.zeros((4, 4, 1, 1), np.float32)))
        err, match = ValueError, 'not consumed'
    f = tmp_path / 'bad.onnx'
    f.write_bytes(data)
    with pytest.raises(err, match=match):
        jonnx.yolo_params_from_onnx(module.sections, variables, f)
    with pytest.raises(err, match=match):
        tonnx.yolo_params_from_onnx(port.layers, port, f)


def test_osnet_onnx_state_dict_matches_jax(tmp_path):
    f = tmp_path / 'osnet.onnx'
    f.write_bytes(onnx_model([
        onnx_tensor('conv1.conv.weight', np.ones((8, 3, 1, 1), np.float32)),
        onnx_tensor('fc.0.weight', np.full((512, 64), 2, np.float32)),
        onnx_tensor('123', np.zeros(2, np.float32))]))
    got = tonnx.torch_state_dict_from_onnx(f)
    want = jonnx.torch_state_dict_from_onnx(f)
    assert got.keys() == want.keys() == {'conv1.conv.weight', 'fc.0.weight'}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --- SSD from TF frozen graphs ----------------------------------------------

def ssd_case(name, with_gamma=True):
    cls = jreg.SSDModel.get_model(name)
    module = cls.build()
    variables = numpy_variables(module, np.zeros((1, 64, 64, 3), np.float32),
                                5)
    consts = _inception_consts(variables, with_gamma) \
        if cls.BACKBONE == 'inception_v2' else _ssd_consts(name, variables)
    return cls, variables, consts, treg.SSDModel.get_model(name).build()


@pytest.mark.parametrize('name,with_gamma', [
    ('SSDMobileNetV1', True), ('SSDMobileNetV2', True),
    ('SSDInceptionV2', True), ('SSDInceptionV2', False)])
def test_ssd_frozen_graph_matches_jax(name, with_gamma):
    cls, variables, consts, port = ssd_case(name, with_gamma)
    want = jssdc.convert_frozen_graph(consts, variables, cls.BACKBONE)
    got = tssdc.convert_frozen_graph(consts, port, cls.BACKBONE)
    assert got.keys() == want.keys() == flax_shapes(port).keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port.load_state_dict(flax_to_state_dict(got))


@pytest.mark.parametrize('name,missing', [
    ('SSDMobileNetV1',
     'FeatureExtractor/MobilenetV1/Conv2d_3_pointwise/weights'),
    ('SSDInceptionV2', 'FeatureExtractor/InceptionV2/Mixed_4c/Branch_2/'
                       'Conv2d_0b_3x3/weights')])
def test_ssd_frozen_graph_missing_raises_like_jax(name, missing):
    cls, variables, consts, port = ssd_case(name)
    consts.pop(missing)
    for convert, model in ((jssdc.convert_frozen_graph, variables),
                           (tssdc.convert_frozen_graph, port)):
        with pytest.raises(KeyError, match=missing.split('/')[-2]):
            convert(consts, model, cls.BACKBONE)


def test_graphdef_and_onnx_readers_match_jax():
    w = np.linspace(0, 1, 54, dtype=np.float32).reshape(3, 3, 2, 3)
    pb = graphdef([tf_node('a/weights', 'Const', tf_tensor(w)),
                   tf_node('b/biases', 'Const',
                           tf_tensor(w[0, 0, 0], content=False))])
    onnx = onnx_model([onnx_tensor('x', w), onnx_tensor('y', w[0], False)])
    for got, want in ((tproto.graphdef_constants(pb),
                       jproto.graphdef_constants(pb)),
                      (tproto.onnx_initializers(onnx),
                       jproto.onnx_initializers(onnx))):
        assert got.keys() == want.keys() and len(want) == 2
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# --- darknet .weights -------------------------------------------------------

@pytest.fixture
def darknet_files(tmp_path):
    sections = jdn.parse_cfg(TINY_CFG)
    n = jdn.count_weight_floats(sections)
    assert tdn.count_weight_floats(tdn.parse_cfg(TINY_CFG)) == n
    header = np.array([0, 2, 5, 32013312, 0], np.int32)
    data = np.random.default_rng(6).normal(size=n + 1).astype(np.float32)
    files = {}
    for kind, count in (('ok', n), ('short', n - 1), ('long', n + 1)):
        files[kind] = tmp_path / f'{kind}.weights'
        files[kind].write_bytes(header.tobytes() + data[:count].tobytes())
    cfg = tmp_path / 'tiny.cfg'
    cfg.write_text(TINY_CFG)
    return sections, cfg, files


def test_darknet_weights_match_jax(darknet_files):
    sections, cfg, files = darknet_files
    module = jdn.DarknetModule(sections=tuple(jdn._hashable(s)
                                              for s in sections))
    variables = numpy_variables(module, np.zeros((1, 64, 64, 3), np.float32),
                                7)
    want, want_hdr = jdn.load_darknet_weights(sections, variables,
                                              files['ok'])
    got, got_hdr = tdn.load_darknet_weights(sections, files['ok'])
    np.testing.assert_array_equal(got_hdr, want_hdr)
    assert_state_dicts_equal(got, flax_to_state_dict(flax_flat(want)))

    # the cfg + weights entry point: the same heads in float32
    port, meta = tdn.yolo_from_cfg(cfg, files['ok'])
    jmod, jparams, jmeta = jdn.yolo_from_cfg(cfg, files['ok'])
    assert meta == jmeta
    x = np.random.default_rng(8).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    for g, w in zip(port(torch.from_numpy(x)),
                    jmod.clone(precision='highest').apply(jparams, x)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize('kind,match', [('short', 'exhausted early'),
                                        ('long', '1 unconsumed floats')])
def test_darknet_weights_errors_match_jax(darknet_files, kind, match):
    sections, cfg, files = darknet_files
    module = jdn.DarknetModule(sections=tuple(jdn._hashable(s)
                                              for s in sections))
    variables = numpy_variables(module, np.zeros((1, 64, 64, 3), np.float32),
                                7)
    with pytest.raises(AssertionError, match=match):
        jdn.load_darknet_weights(sections, variables, files[kind])
    with pytest.raises(AssertionError, match=match):
        tdn.load_darknet_weights(sections, files[kind])


# --- torchreid OSNet checkpoints --------------------------------------------

def test_osnet_convert_matches_jax_and_loads():
    """A torchreid-layout state dict (shapes from the port's OSNet-x0.25)
    converts identically in both packages and loads strictly."""
    port = OSNet()
    shapes = flax_shapes(port)
    rng = np.random.default_rng(9)
    torch_shape = {'conv': lambda s: (s[3], s[2], s[0], s[1]),
                   'dense': lambda s: s[::-1],
                   'gate': lambda s: (s[1], s[0], 1, 1),
                   'copy': lambda s: s}
    ckpt = {tkey: rng.normal(size=torch_shape[kind](shapes[fpath]))
            .astype(np.float32)
            for tkey, fpath, kind in tosc.osnet_key_map()}
    ckpt['classifier.weight'] = np.zeros((10, 512), np.float32)
    got = tosc.convert_state_dict(ckpt)
    want = josc.convert_state_dict(ckpt)
    assert got.keys() == want.keys() == shapes.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    port.load_state_dict(flax_to_state_dict(got))
    with pytest.raises(KeyError, match='conv1.conv.weight'):
        tosc.convert_state_dict({k: v for k, v in ckpt.items()
                                 if k != 'conv1.conv.weight'})


# --- MOT metrics ------------------------------------------------------------

def test_eval_copy_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    gt, res = [], []
    for f in range(1, 31):
        for i in range(4):
            x, y = 40 * i + 2 * f, 30 + 10 * i
            gt.append([f, i + 1, x, y, 30, 60, 1, 1, 1.0])
            if rng.uniform() < 0.85:            # misses, jitter, swaps
                tid = i + 1 if f < 20 or i > 1 else 3 - i
                res.append([f, tid, x + rng.normal(0, 3),
                            y + rng.normal(0, 3), 30, 60, 1, -1, -1, -1])
        res.append([f, 99, 300, 200, 20, 40, 1, -1, -1, -1])
    np.savetxt(tmp_path / 'gt.txt', gt, delimiter=',', fmt='%g')
    np.savetxt(tmp_path / 'res.txt', res, delimiter=',', fmt='%.3f')
    got = teval.evaluate_files(tmp_path / 'gt.txt', tmp_path / 'res.txt')
    want = jeval.evaluate_files(tmp_path / 'gt.txt', tmp_path / 'res.txt')
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 0.4 < got.mota < 0.95 and got.idsw > 0 and got.fp > 0
