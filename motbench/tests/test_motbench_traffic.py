"""The traffic generator: seeded, smooth, inside the capacities."""
import dataclasses
import math
from pathlib import Path

import pytest
import torch

from motbench import traffic as tr

ROOT = Path(__file__).resolve().parents[1]


# a crowded mix (96 people a stream, about 5 % entering or leaving a
# second, 10 % missed, jittered): the generator's every option at once
CROWD = dict(streams=8, objects=96,
             max_swing_px=100.0, centres=(0.85, 0.75), box_width_px=(16, 40),
             leave_share=0.35, miss_rate=0.1, jitter_px=2.0)


def small(**kw):
    return tr.Traffic(**{**CROWD, **kw})


def test_same_seed_same_traffic():
    t = small(frame_size=(96, 64), frame_period=4, drift_px=4)
    a, b = tr.make_frames(t, 5, 'cpu'), tr.make_frames(t, 5, 'cpu')
    assert (a == b).all()
    assert not (a == tr.make_frames(t, 6, 'cpu')).all()
    da = tr.make_detections(t, 2 ** 31 + 77, 5, 1, 'cpu')
    db = tr.make_detections(t, 2 ** 31 + 77, 5, 1, 'cpu')
    assert all(torch.equal(x, y) for x, y in zip(da, db))


def test_streams_differ():
    t = small(frame_size=(96, 64), frame_period=2, drift_px=4, streams=2)
    f = tr.make_frames(t, 3, 'cpu')
    assert not (f[:, 0] == f[:, 1]).all()
    tlbr = tr.make_detections(t, 3, 5, 1, 'cpu')[0]
    assert not torch.equal(tlbr[:, 0], tlbr[:, 1])


@pytest.mark.parametrize('name', ['files8', 'crowd'])
def test_paths_are_smooth_and_close(name):
    """No centre moves more than its sines allow in a frame, the period's
    last frame leads smoothly into its first, and no box jumps."""
    t = small() if name == 'crowd' else \
        tr.Traffic.load(ROOT / 'traffic' / f'{name}.json')
    paths = tr.object_paths(t, 9, 'cpu')
    frames = torch.arange(t.det_period + 1)
    boxes = tr.boxes_at(paths, frames)
    step = (boxes[1:] - boxes[:-1]).abs().amax(-1)
    limit = 2 * math.pi * torch.maximum(paths['ax'] / paths['tx'],
                                        paths['ay'] / paths['ty'])
    assert (step <= limit + 1e-3).all()
    assert torch.allclose(boxes[-1], boxes[0], atol=1e-2)
    assert float(step.max()) < 12.0           # px a frame at 30 FPS


@pytest.mark.parametrize('name', ['files8', 'crowd'])
def test_capacities(name):
    t = small() if name == 'crowd' else \
        tr.Traffic.load(ROOT / 'traffic' / f'{name}.json')
    tlbr, label, conf, valid = tr.make_detections(t, 4, 5, 1, 'cpu')
    assert tlbr.shape[2] == tr.MAX_DETS == 128
    assert int(valid.sum(-1).max()) <= t.objects <= 128
    # the valid rows come first and carry the label
    n = valid.sum(-1, keepdim=True)
    assert torch.equal(valid, torch.arange(128) < n)
    assert bool((label[valid] == 1).all()) and bool((label[~valid] == -1).all())
    w, h = t.frame_size
    b = tlbr[valid]
    assert float(b[:, 0].min()) > -4 * t.jitter_px - 1
    assert float(b[:, 2].max()) < w + 4 * t.jitter_px


def test_dense_mix_rates():
    """About 10 % missed, and the leaving share's objects go out and come
    back: about 5 % of the objects enter or leave each second."""
    t = small()
    paths = tr.object_paths(t, 21, 'cpu')
    frames = torch.arange(t.det_period)
    raw = tr.boxes_at(paths, frames)
    w = t.frame_size[0]
    cx = (raw[..., 0] + raw[..., 2]) / 2
    inside = (cx > 0) & (cx < w)
    changes = (inside[1:] != inside[:-1]).sum().item()
    per_s = changes / (t.streams * t.objects) / (t.det_period / 30)
    assert 0.025 < per_s < 0.1
    valid = tr.make_detections(t, 21, 5, 1, 'cpu')[3]
    det_inside = tr.make_detections(
        dataclasses.replace(t, miss_rate=0.0), 21, 5, 1, 'cpu')[3]
    missed = 1 - valid.sum().item() / det_inside.sum().item()
    assert 0.08 < missed < 0.12


def test_files8_turnover():
    """``files8``: people enter and leave at MOT17-04's rate (83
    identities over 1,050 frames at 30 FPS, 45.3 people a frame: about
    (83 - 45) / 35 s, 2.4 % of the people in view entering a second), and
    about 10 % of them are missed."""
    t = tr.Traffic.load(ROOT / 'traffic' / 'files8.json')
    paths = tr.object_paths(t, 2 ** 31 + 5, 'cpu')
    raw = tr.boxes_at(paths, torch.arange(t.det_period))
    w, h = t.frame_size
    clipped = torch.stack([raw[..., 0].clamp(0, w - 1),
                           raw[..., 1].clamp(0, h - 1),
                           raw[..., 2].clamp(0, w - 1),
                           raw[..., 3].clamp(0, h - 1)], -1)

    def area(b):
        return (b[..., 2] - b[..., 0]).clamp(min=0) * \
            (b[..., 3] - b[..., 1]).clamp(min=0)
    inside = area(clipped) >= 0.5 * area(raw)
    entries = int((inside[1:] & ~inside[:-1]).sum())
    per_s = entries / t.streams / (t.det_period / 30)
    share = per_s / float(inside.float().sum(-1).mean())
    assert 0.015 < share < 0.035, share
    valid = tr.make_detections(t, 2 ** 31 + 5, 5, 1, 'cpu')[3]
    seen = inside[::5].sum().item()
    assert 0.08 < 1 - valid.sum().item() / seen < 0.12


@pytest.mark.parametrize('text', [
    '{"streams": 1, "objects": 200}',
    '{"streams": 1, "objects": 4, "loop": "open"}',
    '{"streams": 1, "objects": 4, "det_period": 1000}'])
def test_bad_files_are_refused(tmp_path, text):
    p = tmp_path / 'bad.json'
    p.write_text(text)
    with pytest.raises((ValueError, TypeError)):
        tr.Traffic.load(p)
