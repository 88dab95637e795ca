"""Build an int8 calibration cache from images (port of
``scripts/calibrate_int8.py``).

    python -m fastmot_tpu_torch.calibrate_int8 --images path/to/imgs \\
        --model YOLOv4 --out yolov4_calib.json --n 32 [--device cpu]

Runs ``models.quantize.EntropyCalibrator`` over N images spread across the
directory (or glob) and writes the JSON cache of KL-optimal ranges for every
submodule output and every eligible conv input, which ``quantize='int8',
calib_cache=...`` of ``YOLODetector``, ``SSDDetector`` and
``FeatureExtractor`` reads (in either package: the keys are the Flax module
paths). Images are prepared as the JAX script prepares them: resized to the
network input (bilinear, half-pixel centres; ReID models at their crop
shape), BGR -> RGB, /255. The resize is done in float on the device, where
the JAX script's ``cv2.resize`` rounds to uint8; cv2 only reads the files.
Runs on the card unless ``--device cpu`` is given.

Unlike the JAX script, which fails for YOLO and SSD models (its calibrator
cannot stack their list or pair of outputs), every zoo model calibrates
here: such an output simply gets no range.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

from .device import torch_device
from .models import registry
from .models.quantize import EntropyCalibrator


def load_images(pattern: str, n: int) -> list[np.ndarray]:
    """Up to ``n`` BGR images spread evenly over the sorted matches."""
    import cv2
    if os.path.isdir(pattern):
        pattern = os.path.join(pattern, '*')
    paths = sorted(p for p in glob.glob(pattern)
                   if p.lower().endswith(('.jpg', '.jpeg', '.png', '.bmp')))
    if not paths:
        raise SystemExit(f'no images match {pattern}')
    idx = np.linspace(0, len(paths) - 1, min(n, len(paths))).astype(int)
    return [cv2.imread(paths[i]) for i in np.unique(idx)]


def calibration_batch(images, hw, device) -> torch.Tensor:
    """``[N, h, w, 3]`` float32 RGB in [0, 1] from BGR uint8 images."""
    out = []
    for img in images:
        t = torch.as_tensor(img, device=device).permute(2, 0, 1)[None]
        t = F.interpolate(t.float(), size=tuple(hw), mode='bilinear',
                          align_corners=False, antialias=False)
        out.append(t[0].permute(1, 2, 0).flip(-1) / 255.0)
    return torch.stack(out)


def find_model(name: str):
    for family in (registry.YOLOModel, registry.SSDModel,
                   registry.ReIDModel):
        try:
            return family.get_model(name)
        except KeyError:
            continue
    raise SystemExit(f'unknown zoo model {name!r}')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--images', required=True,
                    help='image directory or glob of calibration images')
    ap.add_argument('--model', required=True,
                    help='zoo model name (YOLOv4, SSDInceptionV2, '
                         'OSNet025, ...)')
    ap.add_argument('--out', required=True, help='output cache JSON')
    ap.add_argument('--n', type=int, default=32,
                    help='number of calibration images')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    device = torch_device(args.device)
    model = find_model(args.model)
    module = model.init_params(device)
    c, ih, iw = model.INPUT_SHAPE
    images = load_images(args.images, args.n)
    batch = calibration_batch(images, (ih, iw), device).cpu().numpy()

    cal = EntropyCalibrator(module)
    for i in range(0, len(batch), args.batch):
        cal.observe(batch[i:i + args.batch])
    cal.save(args.out)
    print(f'{args.out}: {len(cal.compute_ranges())} output ranges, '
          f'{len(cal.compute_input_ranges())} conv-input ranges from '
          f'{len(images)} images ({args.model} @ {ih}x{iw})')


if __name__ == '__main__':
    main()
