"""int8 on whole models against the JAX package, beside
tests/test_torch_quantize.py (whose helpers this file uses): the entropy
calibrator and the calibrated modes on OSNet-x0.25 (both packages
calibrate the same weights on the same two batches; the port then loads
the cache file the JAX package's ``EntropyCalibrator.save`` wrote), and
the SSD path."""
import json

import numpy as np
import pytest
import torch

from fastmot_tpu.models import osnet as josnet
from fastmot_tpu.models import quantize as jq
from fastmot_tpu.models import ssd as jssd
from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch.models import osnet as tosnet
from fastmot_tpu_torch.models import quantize as tq
from fastmot_tpu_torch.models import ssd as tssd
from tests.test_torch_quantize import (CROPS, MAX_REL,  # noqa: F401
                                       MEAN_REL, MIN_COS, check_osnet_mode,
                                       close_share, jax_apply, min_cos,
                                       one_thread, port_apply, port_model,
                                       rel, to_flax)


@pytest.fixture(scope='module')
def osnet_cal(tmp_path_factory):
    """OSNet-x0.25 calibrated in both packages on the same two batches;
    the JAX package's cache file."""
    rng = np.random.default_rng(9)
    batches = [rng.uniform(-2, 2, CROPS).astype(np.float32)
               for _ in range(2)]
    variables = to_flax(port_model(tosnet.OSNet025))
    jcal = jq.EntropyCalibrator(josnet.OSNet025.build(), variables,
                                num_bins=256)
    tcal = tq.EntropyCalibrator(port_model(tosnet.OSNet025), num_bins=256)
    for b in batches:
        jcal.observe(b)
        tcal.observe(b)
    cache = tmp_path_factory.mktemp('cal') / 'osnet025.json'
    jcal.save(cache)
    return jcal, tcal, cache, variables


def test_calibrator_matches_jax_on_osnet(osnet_cal):
    jcal, tcal, _, _ = osnet_cal
    jout, tout = jcal.compute_ranges(), tcal.compute_ranges()
    assert set(tout) == set(jout) and '__call__' in tout
    # every submodule and the root but the second dense layer of a gate
    # whose one hidden unit the ReLU zeroes on this data (321 keys with
    # the JAX package's own init)
    keys = {n.replace('.', '/') or '__call__'
            for n, _ in tcal.module.named_modules()}
    assert len(keys) == 324 and set(tout) <= keys
    assert all(k.endswith('AggregationGate_0/Dense_1')
               for k in keys - set(tout))
    jin, tin = jcal.compute_input_ranges(), tcal.compute_input_ranges()
    assert set(tin) == set(jin) and len(tin) == 79
    assert not any('Depthwise' in k for k in tin)
    assert close_share(tout, jout) >= 0.95
    assert close_share(tin, jin) >= 0.95


def test_osnet_calibrated_outputs_match_jax(osnet_cal):
    """Fake-quant of every calibrated submodule output."""
    jcal, _, _, variables = osnet_cal
    check_osnet_mode(variables, act_ranges=jcal.compute_ranges())


def test_osnet_jax_cache_file_matches_jax(osnet_cal):
    """The file the JAX package saved, through the port's knob: native
    convs at its input ranges, fake-quant of the other outputs."""
    _, _, cache, variables = osnet_cal
    check_osnet_mode(variables, *jq.load_calib_ranges(cache),
                     port_module=tq.quantize_module(
                         port_model(tosnet.OSNet025), 'int8', cache))


@pytest.mark.parametrize('in_ranges', [None, {'*': 0.0}],
                         ids=['weights', 'dynamic'])
def test_ssd_int8_matches_jax(in_ranges):
    """SSD-MobileNetV1 on two 300x300 tiles, weight-only and with dynamic
    native convs (the depthwise convs are the shifted-tap layer in both
    packages, never native)."""
    module = port_model(tssd.SSDMobileNetV1)
    x = np.random.default_rng(16).uniform(-1, 1, (2, 300, 300, 3)) \
        .astype(np.float32)
    jm = jq.QuantizedModule(jssd.SSDMobileNetV1.build(), None, in_ranges)
    want = jax_apply(jm, jm.quantize(to_flax(module)), x)
    got = port_apply(tq.QuantizedModule(port_model(tssd.SSDMobileNetV1),
                                        None, in_ranges), x)
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(2, 1917, 4), (2, 1917, 91)]
    for g, w in zip(got, want):
        if in_ranges is None:
            max_rel, mean_rel = rel(g, w)
            assert max_rel < MAX_REL and mean_rel < MEAN_REL, (max_rel,
                                                               mean_rel)
        else:
            assert min_cos(g, w) >= MIN_COS


@pytest.mark.parametrize('cached', [False, True], ids=['weights', 'cache'])
def test_ssd_detector_int8_knob(cached, tmp_path):
    """``SSDDetector(quantize='int8')`` with and without bench.py
    --int8's cache: the network is a QuantizedModule and the tiled
    detector runs."""
    cache = None
    if cached:
        cache = tmp_path / 'cal.json'
        cache.write_text(json.dumps({'outputs': {}, 'inputs': {'*': 0.0}}))
    det = tdet.SSDDetector((320, 240), (1,), model='SSDMobileNetV1',
                           tiling_grid=(2, 1), quantize='int8',
                           calib_cache=cache, device='cpu')
    assert isinstance(det.module, tq.QuantizedModule)
    assert det.module.in_ranges == ({'*': 0.0} if cached else None)
    frame = np.random.default_rng(17).integers(0, 256, (240, 320, 3),
                                               dtype=np.uint8)
    det.detect_async(torch.from_numpy(frame))
    padded = det.postprocess_device()
    assert [tuple(t.shape) for t in padded] == [(tdet.MAX_DETS, 4)] + \
        [(tdet.MAX_DETS,)] * 3
