"""Model registries (port of ``fastmot_tpu/models/registry.py``).

A model class builds an ``nn.Module``; ``init_params`` loads
``models/weights/<Name>.npz`` (the JAX package's weight files, read by
``load_npz``, strictly) when it exists, and otherwise draws a random init
from a ``torch.Generator`` seeded with ``seed``. ``save_npz`` writes a
module in that format (``python -m fastmot_tpu_torch.convert_weights``).
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / 'fastmot_tpu' / \
    'models' / 'weights'

_YOLO_REGISTRY: dict[str, type] = {}
_SSD_REGISTRY: dict[str, type] = {}
_REID_REGISTRY: dict[str, type] = {}


def load_npz(module: torch.nn.Module, path, strict: bool = True):
    """Overlay a JAX-package ``.npz`` (flat Flax paths) onto ``module``'s
    parameters and buffers; returns ``module``.

    ``strict`` (default) raises if any npz key matches no entry of the
    module or any entry is left uncovered: a partial overlay must never
    pass for loaded weights. ``strict=False`` overlays what matches and
    warns."""
    from ..weights import flax_shapes, flax_to_state_dict
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    want = flax_shapes(module)
    for name in want.keys() & flat.keys():
        if tuple(flat[name].shape) != want[name]:
            raise ValueError(f'{path}: shape mismatch for {name}: '
                             f'{tuple(flat[name].shape)} vs expected '
                             f'{want[name]}')
    unmatched = sorted(flat.keys() - want.keys())
    missing = sorted(want.keys() - flat.keys())
    if strict and (unmatched or missing):
        raise ValueError(
            f'{path} does not cover the module: {len(unmatched)} unmatched '
            f'npz keys (e.g. {unmatched[:3]}), {len(missing)} uncovered '
            f'entries (e.g. {missing[:3]}). Regenerate with python -m '
            f'fastmot_tpu_torch.convert_weights, or pass strict=False for a '
            f'deliberate partial overlay.')
    if unmatched:
        LOGGER.warning('%s: %d npz keys unmatched', path, len(unmatched))
    if missing:
        LOGGER.warning('%s: %d entries left at their values', path,
                       len(missing))
    module.load_state_dict(flax_to_state_dict(
        {k: v for k, v in flat.items() if k in want}), strict=False)
    return module


def save_npz(module: torch.nn.Module, path):
    """Save ``module`` as a flat JAX-package ``.npz`` (weight conversion)."""
    from ..weights import save_npz as save
    save(module, path)


def register_yolo(cls):
    _YOLO_REGISTRY[cls.__name__] = cls
    return cls


def register_ssd(cls):
    _SSD_REGISTRY[cls.__name__] = cls
    return cls


def register_reid(cls):
    _REID_REGISTRY[cls.__name__] = cls
    return cls


class _ModelBase:
    INPUT_SHAPE: tuple[int, int, int]  # (C, H, W), reference layout

    @classmethod
    def build(cls):
        raise NotImplementedError

    @classmethod
    def init_params(cls, device='cpu', seed: int = 0):
        """The model's module, in eval mode on ``device``."""
        from .layers import random_init_
        module = cls.build()
        npz = WEIGHTS_DIR / f'{cls.__name__}.npz'
        if npz.exists():
            load_npz(module, npz)
            LOGGER.info('Loaded weights from %s', npz)
        else:
            LOGGER.warning('No pretrained weights at %s - using random init',
                           npz)
            random_init_(module, torch.Generator().manual_seed(seed))
        return module.requires_grad_(False).to(device).eval()


class YOLOModel(_ModelBase):
    NUM_CLASSES: int
    LETTERBOX: bool = False

    @classmethod
    def get_model(cls, name: str):
        return _YOLO_REGISTRY[name]


class SSDModel(_ModelBase):
    NUM_CLASSES: int
    TOPK: int = 100
    NMS_THRESH: float = 0.5   # NMS_TRT nmsThreshold (reference ssd.py:105)

    @classmethod
    def get_model(cls, name: str):
        return _SSD_REGISTRY[name]


class ReIDModel(_ModelBase):
    OUTPUT_LAYOUT: int
    METRIC: str

    @classmethod
    def get_model(cls, name: str):
        return _REID_REGISTRY[name]
