"""Every registered YOLO of the port constructs and runs as a
``YOLODetector`` on the CPU: full-width networks with random weights,
the input cut to 64x64 so that a forward takes a fraction of a second.
Parity with the JAX package is in ``test_torch_yolo_zoo.py`` (parameter
trees of all eleven, float32 forwards of three, the letterbox path)."""
import numpy as np
import pytest
import torch

from fastmot_tpu_torch.detector import MAX_DETS, YOLODetector
from fastmot_tpu_torch.models import registry

from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

YOLO_NAMES = sorted(registry._YOLO_REGISTRY)
SIZE = (96, 64)             # a wide frame: the letterboxed models pad rows


@pytest.mark.parametrize('name', YOLO_NAMES)
def test_yolo_detector_runs_on_cpu(monkeypatch, name):
    model = registry.YOLOModel.get_model(name)
    monkeypatch.setattr(model, 'INPUT_SHAPE', (3, 64, 64))
    det = YOLODetector(SIZE, (0,), model=name, conf_thresh=0.3,
                       min_aspect_ratio=0.0, device='cpu')
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (SIZE[1], SIZE[0], 3), dtype=np.uint8))

    with torch.no_grad():
        heads = det.module(det.preprocess(frame))
    want = [(1, 64 // f, 64 // f, len(a) // 2 * (5 + model.NUM_CLASSES))
            for f, a in zip(model.LAYER_FACTORS, model.ANCHORS)]
    assert [tuple(h.shape) for h in heads] == want
    assert all(bool(torch.isfinite(h).all()) for h in heads)

    det.detect_async(frame)
    tlbr, label, conf, valid = det.postprocess_device()
    n_boxes = sum(h * w * c // (5 + model.NUM_CLASSES)
                  for _, h, w, c in want)
    n_rows = min(MAX_DETS, n_boxes)
    assert tlbr.shape == (n_rows, 4)
    assert label.shape == conf.shape == valid.shape == (n_rows,)

    dets = det(frame)
    assert len(dets) == int(valid.sum())
    np.testing.assert_array_equal(dets.tlbr, tlbr[valid].numpy())
    assert np.isfinite(dets.tlbr).all()
    assert (dets.label == 0).all()
    assert ((dets.conf >= 0.3) & (dets.conf <= 1)).all()
