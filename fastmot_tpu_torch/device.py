"""The device every entry point of the port places its state on.

The entry points (``MOT``, the detectors, ``FeatureExtractor``,
``MultiTracker``, ``Flow`` and the CLI) run on the card unless the caller
asks for the CPU with ``device='cpu'``; without a card they raise.
"""
from __future__ import annotations

import torch


def torch_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(device)!r}: no CUDA device is available; pass '
            "device='cpu' (--device cpu on the command line) to run on the "
            'CPU')
    return dev
