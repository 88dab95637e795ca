"""Model registries (port of ``fastmot_tpu/models/registry.py``).

A model class builds an ``nn.Module``; ``init_params`` loads
``models/weights/<Name>.npz`` (the JAX package's weight files, converted
by ``weights.load_npz``) when it exists, and otherwise draws a random init
from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import logging
from pathlib import Path

import torch

LOGGER = logging.getLogger(__name__)

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / 'fastmot_tpu' / \
    'models' / 'weights'

_YOLO_REGISTRY: dict[str, type] = {}
_SSD_REGISTRY: dict[str, type] = {}
_REID_REGISTRY: dict[str, type] = {}


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
        from ..weights import load_npz
        from .layers import random_init_
        module = cls.build()
        npz = WEIGHTS_DIR / f'{cls.__name__}.npz'
        if npz.exists():
            module.load_state_dict(load_npz(npz))
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
