"""The port's JAX-free converter (``python -m
fastmot_tpu_torch.convert_weights``) against the JAX package's CLI
(``scripts/convert_weights.py``, loaded by importlib and called as it is):
for darknet (an explicit cfg and a registered YOLO), onnx, osnet (``.pth``
and ``.onnx``) and ssd, the synthetic checkpoints of
tests/test_torch_importers.py go through both into ``tmp_path``; the two
``.npz`` files have the same keys, dtypes and bits, and the port's file
loads strictly into the registered model. ``registry.load_npz`` raises
under ``strict=True`` on a file missing one key and overlays with a
warning otherwise; ``registry.save_npz`` round-trips a module bit for
bit."""
import argparse
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from fastmot_tpu.models import darknet as jdn
from fastmot_tpu.models import registry as jreg
from fastmot_tpu_torch import convert_weights
from fastmot_tpu_torch.models import osnet_convert as tosc
from fastmot_tpu_torch.models import registry as treg
from fastmot_tpu_torch.models.layers import random_init_
from fastmot_tpu_torch.weights import flax_shapes

from .test_checkpoint_import import _ssd_consts, _yolo_onnx_bytes
from .test_darknet import TINY_CFG
from .test_protoparse import graphdef, onnx_model, onnx_tensor, tf_node, \
    tf_tensor
from .test_torch_ssd import (  # noqa: F401 (autouse fixture)
    numpy_variables, one_torch_thread)

ROOT = Path(__file__).parents[1]


@pytest.fixture(scope='module')
def jax_cli():
    spec = importlib.util.spec_from_file_location(
        'jax_convert_weights', ROOT / 'scripts' / 'convert_weights.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same_files(got, want):
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            assert g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
        return len(w.files)


def both(jax_cli, tmp_path, fn, argv, **jax_args):
    """The JAX CLI's ``fn`` and the port's CLI on the same input, each into
    its own file; returns the port's file and the key count."""
    want, got = tmp_path / 'jax.npz', tmp_path / 'port.npz'
    getattr(jax_cli, fn)(argparse.Namespace(out=str(want), **jax_args))
    convert_weights.main(argv + ['--out', str(got)])
    return got, same_files(got, want)


def weights_file(path, sections, seed):
    n = jdn.count_weight_floats(sections)
    header = np.array([0, 2, 5, 32013312, 0], np.int32)
    data = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    path.write_bytes(header.tobytes() + data.tobytes())
    return path


def test_darknet_cfg_matches_jax_cli(jax_cli, tmp_path):
    cfg = tmp_path / 'tiny.cfg'
    cfg.write_text(TINY_CFG)
    weights = weights_file(tmp_path / 'tiny.weights', jdn.parse_cfg(TINY_CFG),
                           1)
    got, n = both(jax_cli, tmp_path, 'convert_darknet',
                  ['darknet', '--cfg', str(cfg), '--weights', str(weights)],
                  model=None, cfg=str(cfg), weights=str(weights))
    assert n > 10


def test_darknet_model_matches_jax_cli_and_loads(jax_cli, tmp_path):
    sections = jreg.YOLOModel.get_model('YOLOv4Tiny').build().sections
    weights = weights_file(tmp_path / 'y.weights', sections, 2)
    got, n = both(jax_cli, tmp_path, 'convert_darknet',
                  ['darknet', '--model', 'YOLOv4Tiny', '--weights',
                   str(weights)],
                  model='YOLOv4Tiny', cfg=None, weights=str(weights))
    module = treg.load_npz(treg.YOLOModel.get_model('YOLOv4Tiny').build(),
                           got, strict=True)
    assert n == len(module.state_dict())


def test_onnx_matches_jax_cli(jax_cli, tmp_path):
    module = jreg.YOLOModel.get_model('YOLOv4Tiny').build()
    variables = numpy_variables(module, np.zeros((1, 64, 64, 3), np.float32),
                                4)
    f = tmp_path / 'yolo.onnx'
    f.write_bytes(_yolo_onnx_bytes(module.sections, variables, None))
    got, _ = both(jax_cli, tmp_path, 'convert_onnx_yolo',
                  ['onnx', '--model', 'YOLOv4Tiny', '--onnx', str(f)],
                  model='YOLOv4Tiny', onnx=str(f))
    treg.load_npz(treg.YOLOModel.get_model('YOLOv4Tiny').build(), got)


def osnet_checkpoint():
    """A torchreid-layout state dict shaped by the port's OSNet-x0.25
    (tests/test_torch_importers.py), with a classifier the map drops."""
    shapes = flax_shapes(treg.ReIDModel.get_model('OSNet025').build())
    torch_shape = {'conv': lambda s: (s[3], s[2], s[0], s[1]),
                   'dense': lambda s: s[::-1],
                   'gate': lambda s: (s[1], s[0], 1, 1),
                   'copy': lambda s: s}
    rng = np.random.default_rng(9)
    ckpt = {tkey: rng.normal(size=torch_shape[kind](shapes[fpath]))
            .astype(np.float32)
            for tkey, fpath, kind in tosc.osnet_key_map()}
    ckpt['classifier.weight'] = np.zeros((10, 512), np.float32)
    return ckpt


@pytest.mark.parametrize('suffix', ['.pth', '.onnx'])
def test_osnet_matches_jax_cli(jax_cli, tmp_path, suffix):
    ckpt = osnet_checkpoint()
    f = tmp_path / f'osnet{suffix}'
    if suffix == '.pth':     # DataParallel names, as torchreid saves them
        torch.save({'state_dict': {f'module.{k}': torch.from_numpy(v)
                                   for k, v in ckpt.items()}}, f)
    else:
        f.write_bytes(onnx_model([onnx_tensor(k, v)
                                  for k, v in ckpt.items()]))
    got, n = both(jax_cli, tmp_path, 'convert_osnet',
                  ['osnet', '--ckpt', str(f), '--model', 'OSNet025'],
                  ckpt=str(f), model='OSNet025')
    treg.load_npz(treg.ReIDModel.get_model('OSNet025').build(), got)
    assert n == len(osnet_checkpoint()) - 1


def test_ssd_matches_jax_cli(jax_cli, tmp_path):
    name = 'SSDMobileNetV1'
    module = jreg.SSDModel.get_model(name).build()
    variables = numpy_variables(module, np.zeros((1, 64, 64, 3), np.float32),
                                5)
    consts = _ssd_consts(name, variables)
    f = tmp_path / 'ssd.pb'
    f.write_bytes(graphdef([tf_node(k, 'Const', tf_tensor(
        np.ascontiguousarray(v, np.float32))) for k, v in consts.items()]))
    got, _ = both(jax_cli, tmp_path, 'convert_ssd',
                  ['ssd', '--model', name, '--pb', str(f)],
                  model=name, pb=str(f))
    treg.load_npz(treg.SSDModel.get_model(name).build(), got)


def test_load_npz_strict_and_partial(tmp_path, caplog):
    module = treg.ReIDModel.get_model('OSNet025').build()
    random_init_(module, torch.Generator().manual_seed(3))
    full = tmp_path / 'full.npz'
    treg.save_npz(module, full)
    with np.load(full) as data:
        flat = {k: data[k] for k in data.files}
    dropped = sorted(flat)[0]
    del flat[dropped]
    part = tmp_path / 'part.npz'
    np.savez(part, **flat)
    fresh = treg.ReIDModel.get_model('OSNet025').build()
    with pytest.raises(ValueError, match=r'0 unmatched npz keys .* 1 '
                                         r'uncovered entries'):
        treg.load_npz(fresh, part, strict=True)
    with pytest.raises(ValueError, match='convert_weights'):
        treg.load_npz(fresh, part)
    with caplog.at_level(logging.WARNING):
        treg.load_npz(fresh, part, strict=False)
    assert any('1 entries left' in r.message for r in caplog.records)
    sd, want = fresh.state_dict(), module.state_dict()
    for k in want:
        if k.replace('.', '/') not in dropped:
            assert torch.equal(sd[k], want[k]), k


@pytest.mark.parametrize('kind,name', [('yolo', 'YOLOv4Tiny'),
                                       ('reid', 'OSNet025'),
                                       ('ssd', 'SSDMobileNetV1')])
def test_save_npz_round_trips_bit_for_bit(tmp_path, kind, name):
    get = {'yolo': treg.YOLOModel, 'reid': treg.ReIDModel,
           'ssd': treg.SSDModel}[kind].get_model
    module = get(name).build()
    random_init_(module, torch.Generator().manual_seed(5))
    with torch.no_grad():       # non-trivial batch norms
        for k, v in module.state_dict().items():
            if k.endswith(('running_mean', 'running_var', 'bias')) \
                    or v.dim() == 1:
                v.uniform_(0.5, 1.5)
    f = tmp_path / f'{name}.npz'
    treg.save_npz(module, f)
    fresh = treg.load_npz(get(name).build(), f, strict=True)
    want = module.state_dict()
    got = fresh.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    with np.load(f) as data:
        assert {k: data[k].shape for k in data.files} == flax_shapes(module)
