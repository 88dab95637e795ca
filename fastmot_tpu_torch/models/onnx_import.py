"""Import weights from the reference's released ONNX checkpoints (port of
``fastmot_tpu/models/onnx_import.py``).

The reference distributes exactly two kinds of ONNX files
(scripts/download_models.sh): YOLO models exported by its own
scripts/yolo2onnx.py, and OSNet ReID models exported from torchreid by
torch.onnx. Both are consumed here without the onnx package, via the
wire-format reader (protoparse.onnx_initializers):

  * yolo2onnx names every parameter ``{NNN}_convolutional_{conv|bn}_
    {weights|bias|scale|mean|var}`` where NNN is the cfg section ordinal
    (net = 000) — see yolo2onnx.py:249-263. Our zoo modules ARE
    DarknetModules built from the same cfgs, so section ordinal i+1 in
    the ONNX file is layer i in ``DarknetModule`` (``conv{i}``/``bn{i}``)
    and the mapping is exact; the port's kernels are OIHW as in the file.

  * torch.onnx keeps state_dict keys as initializer names
    (``conv1.conv.weight``...), which is the exact input
    osnet_convert.convert_state_dict already consumes.

Every import is shape-checked leaf by leaf and verified for full
coverage: unknown initializers or unfilled model convolutions raise.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from .protoparse import onnx_initializers

_YOLO_RE = re.compile(
    r'^(\d{3})_convolutional_(conv|bn)_(weights|bias|scale|mean|var)$')


def yolo_params_from_onnx(sections, module, onnx_path):
    """Map a yolo2onnx-exported .onnx onto a DarknetModule's parameters.

    ``sections``/``module`` come from the registered zoo model
    (models/yolo.py builds each model from its upstream cfg). Returns the
    module's state dict.
    """
    inits = onnx_initializers(Path(onnx_path).read_bytes())
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = {}

    layers = [s for s in sections if s['type'] != 'net']
    consumed = set()

    def take(name, expect_shape):
        if name not in inits:
            raise KeyError(
                f'ONNX file has no initializer {name!r} — was this file '
                f'exported by yolo2onnx.py from the same cfg?')
        arr = np.asarray(inits[name], np.float32)
        if tuple(arr.shape) != tuple(expect_shape):
            raise ValueError(
                f'{name}: shape {arr.shape} != model {tuple(expect_shape)}')
        consumed.add(name)
        return arr

    n_convs = 0
    for i, sec in enumerate(layers):
        if sec['type'] != 'convolutional':
            continue
        n_convs += 1
        base = f'{i + 1:03d}_convolutional'    # net section is ordinal 000
        kshape = shapes[f'conv{i}.weight']      # OIHW
        cout = kshape[0]
        sd[f'conv{i}.weight'] = take(f'{base}_conv_weights', kshape)
        if int(sec.get('batch_normalize', 0)):
            for ours, onnx in (('weight', 'scale'), ('bias', 'bias'),
                               ('running_mean', 'mean'),
                               ('running_var', 'var')):
                sd[f'bn{i}.{ours}'] = take(f'{base}_bn_{onnx}', (cout,))
        else:
            sd[f'conv{i}.bias'] = take(f'{base}_conv_bias', (cout,))
    if not n_convs:
        raise ValueError('model has no convolutional sections')

    leftover = {k for k in inits if _YOLO_RE.match(k)} - consumed
    if leftover:
        raise ValueError(
            f'{len(leftover)} convolutional initializers in the ONNX file '
            f'were not consumed (cfg mismatch): {sorted(leftover)[:5]}...')
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def torch_state_dict_from_onnx(onnx_path):
    """{state_dict_key: ndarray} from a torch.onnx-exported file —
    drop-in for torch.load()['state_dict'] in osnet conversion."""
    inits = onnx_initializers(Path(onnx_path).read_bytes())
    # torch exports every parameter under its state_dict key; constant-
    # folded aux tensors get numeric names — filter those out
    return {k: np.asarray(v) for k, v in inits.items()
            if not k.isdigit() and '.' in k}
