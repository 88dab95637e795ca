"""Dynamic int8 input ranges over a stream axis and over a mesh, against
the JAX package and the port's own single-stream and unsharded runs:

- ``FeatureExtractor.extract_async_batch`` under dynamic int8 (every
  native conv quantised at its input's absmax) on 3 streams whose crops
  differ in brightness: each stream's crops take their own ranges, as the
  JAX package's ``vmap`` over streams gives them. It matches JAX's
  ``extract_async_batch`` per stream within the int8 tolerance of
  tests/test_torch_quantize_models.py (cosine >= 0.999 per embedding) and
  the port's single-stream extraction of each stream within 1e-6 (the
  native convs' integer sums are exact; the float layers see a larger
  batch);
- ``MultiStreamMOT`` under dynamic int8 (YOLOv4-tiny and OSNet-x0.25) on a
  2-rank gloo CPU mesh, streams of different brightness: each rank's
  detector takes the range of all streams' frames (one all-reduce per
  native conv), so its network finds the unsharded run's detections
  (boxes within 1e-3 px, scores within 1e-5), and the tracks are the
  unsharded run's (the IDs, ages and hits; boxes within 1e-3 px).
"""
import contextlib
import json

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from fastmot_tpu import feature_extractor as jfe
from fastmot_tpu_torch import feature_extractor as tfe
from fastmot_tpu_torch import multichip
from fastmot_tpu_torch.feature_extractor import FeatureExtractor
from fastmot_tpu_torch.models import osnet as tosnet
from fastmot_tpu_torch.models import quantize as tq
from fastmot_tpu_torch.parallel import MultiStreamMOT

from .test_torch_quantize import MIN_COS, min_cos, port_model, to_flax
from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

EMB_ATOL = 1e-6
BOX_PX, SCORE_ATOL = 1e-3, 1e-5


@pytest.fixture(scope='module')
def dynamic_cache(tmp_path_factory):
    """bench.py --int8's cache: every eligible conv native, dynamic."""
    path = tmp_path_factory.mktemp('int8') / 'dynamic.json'
    path.write_text(json.dumps({'outputs': {}, 'inputs': {'*': 0.0}}))
    return path


def textured(rng, h, w, gain):
    base = ndi.gaussian_filter(rng.uniform(0, 255, (h, w, 3))
                               .astype(np.float32), (2, 2, 0))
    return np.clip(base * gain, 0, 255).astype(np.uint8)


def test_batched_extractor_takes_per_stream_ranges(dynamic_cache):
    rng = np.random.default_rng(21)
    gains = (0.25, 1.0, 0.55)
    frames = np.stack([textured(rng, 96, 128, g) for g in gains])
    tlbrs = np.array([[[4, 6, 60, 90], [50, 10, 120, 80]]] * 3, np.float32)
    tlbrs += rng.uniform(0, 4, tlbrs.shape).astype(np.float32)
    valid = np.ones(tlbrs.shape[:2], bool)

    float_module = port_model(tosnet.OSNet025)
    jext = jfe.FeatureExtractor('OSNet025', quantize='int8',
                                calib_cache=str(dynamic_cache))
    jext.params = jext.module.quantize(to_flax(float_module))
    jext.extract_async_batch(frames, tlbrs, valid)
    want = np.asarray(jext.postprocess_device())

    ext = FeatureExtractor('OSNet025', device='cpu')
    ext.module = tq.quantize_module(float_module, 'int8', dynamic_cache)
    assert isinstance(ext.module, tq.QuantizedModule)
    args = [torch.from_numpy(a) for a in (frames, tlbrs, valid)]
    ext.extract_async_batch(*args)
    got = ext.postprocess_device().numpy()
    assert got.shape == want.shape == (3, 2, 512)
    singles = []
    for s in range(3):
        ext.extract_async_device(*(a[s] for a in args))
        singles.append(ext.postprocess_device().numpy())
        assert min_cos(got[s], want[s]) >= MIN_COS, s
        np.testing.assert_allclose(got[s], singles[s], rtol=0,
                                   atol=EMB_ATOL)
    # the streams' ranges do differ: one range over all six crops moves
    # the embeddings far beyond the tolerance
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfe, 'dynamic_ranges',
                   lambda groups: contextlib.nullcontext())
        ext.extract_async_batch(*args)
        pooled = ext.postprocess_device().numpy()
    assert np.abs(pooled - got).max() > 1000 * EMB_ATOL


def _frames(n_streams, n_frames, size):
    """Stream s drifts 2 px a frame; its brightness rises with s, so each
    rank's frames have a narrower range than all streams'."""
    w, h = size
    out = []
    for s in range(n_streams):
        big = textured(np.random.default_rng(60 + s), h + 8, w + 8,
                       0.4 + 0.2 * s)
        out.append([big[i:i + h, 2 * i:2 * i + w] for i in range(n_frames)])
    return np.stack([np.stack([out[s][i] for s in range(n_streams)])
                     for i in range(n_frames)])


def _dets(n_streams, det_frames, d_cap):
    tlbr = np.zeros((len(det_frames), n_streams, d_cap, 4), np.float32)
    valid = np.zeros((len(det_frames), n_streams, d_cap), bool)
    for i, f in enumerate(det_frames):
        for s in range(n_streams):
            n = 2 + s
            x = 4.0 + 29 * np.arange(n) + 2 * f
            y = 10.0 + 9 * np.arange(n) + f
            tlbr[i, s, :n] = np.stack([x, y, x + 26, y + 60], -1)
            valid[i, s, :n] = True
    return dict(frames=np.array(det_frames), tlbr=tlbr,
                label=np.where(valid, 0, -1).astype(np.int32),
                conf=np.where(valid, 0.9, 0).astype(np.float32),
                valid=valid)


N_STREAMS, N_FRAMES, D_CAP, SIZE = 4, 3, 8, (320, 256)


def mot_kwargs(cache):
    int8 = {'quantize': 'int8', 'calib_cache': str(cache)}
    return dict(size=SIZE, detector_frame_skip=2, class_ids=(0,),
                yolo_detector_cfg=dict(model='YOLOv4Tiny', conf_thresh=0.2,
                                       **int8),
                feature_extractor_cfgs=(dict(model='OSNet025', **int8),),
                tracker_cfg={'max_age': 3})


def test_mesh_int8_takes_the_global_detector_range(dynamic_cache, tmp_path):
    frames = _frames(N_STREAMS, N_FRAMES, SIZE)
    dets = _dets(N_STREAMS, [0, 2], D_CAP)
    np.save(tmp_path / 'frames.npy', frames)
    np.savez(tmp_path / 'dets.npz', **dets)
    kwargs = mot_kwargs(dynamic_cache)
    size = kwargs.pop('size')
    mot = MultiStreamMOT(size, N_STREAMS, device='cpu', **kwargs)
    assert isinstance(mot.detector._single.module, tq.QuantizedModule)
    ref, _ = multichip.run_multi_stream(mot, frames, dets,
                                        sync_every_frame=True)
    ref_dets = mot.network_dets
    assert sorted(ref_dets) == [0, 2]
    assert sum(len(d[2]) for d in ref_dets[2]) > 0
    ranks = multichip.run_ranks(2, multichip.multi_stream_rank, (
        str(tmp_path), N_STREAMS, 1, mot_kwargs(dynamic_cache), 'cpu', 'cpu',
        True))
    for rank, out in enumerate(ranks):
        mine = out['local_streams']
        assert mine == [2 * rank, 2 * rank + 1]
        for f, found in out['network_dets'].items():
            for (tlbr, label, conf), s in zip(found, mine):
                w_tlbr, w_label, w_conf = ref_dets[f][s]
                np.testing.assert_array_equal(label, w_label)
                np.testing.assert_allclose(tlbr, w_tlbr, rtol=0,
                                           atol=BOX_PX)
                np.testing.assert_allclose(conf, w_conf, rtol=0,
                                           atol=SCORE_ATOL)
        for f, (got, want) in enumerate(zip(out['rows'], ref)):
            for s in mine:
                assert [r[0] for r in got[s]] == [r[0] for r in want[s]]
                assert [r[2:] for r in got[s]] == [r[2:] for r in want[s]]
                for g, w in zip(got[s], want[s]):
                    assert np.abs(np.subtract(g[1], w[1])).max() <= BOX_PX
