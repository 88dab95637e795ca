"""Darknet .cfg interpreter as a torch module, and the .weights loader
(port of ``fastmot_tpu/models/darknet.py``).

The parsed cfg is the model: ``DarknetModule`` runs the layer list on NHWC
tensors and returns the raw yolo-head maps. Layers: convolutional (bn +
leaky/mish/swish/logistic/linear), shortcut, route (concat + groups),
upsample, maxpool, yolo. Module names are the Flax ones (``conv{i}``,
``bn{i}``), so the JAX package's parameters load by name. Convs compute in
``dtype`` (bf16 for the registered models, float32 for parity checks) with
f32 BN. The stem is a plain conv: the JAX package's space-to-depth fold is
a TPU layout trick, but its folded convs keep their f32 sums where a plain
bf16 conv rounds its output, so the port's stem convs (the layers the JAX
package folds, ``stem_layers``) keep the f32 sum too.

``load_darknet_weights`` maps a released ``.weights`` file onto the
module's state dict in traversal order, as strictly as the JAX loader: a
file too short or too long raises.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, max_pool_same


def parse_cfg(text: str) -> list[dict]:
    """Parse Darknet cfg text into an ordered list of section dicts."""
    sections: list[dict] = []
    for raw in text.splitlines():
        line = raw.split('#')[0].strip()
        if not line:
            continue
        if line.startswith('['):
            sections.append({'type': line.strip('[]').strip()})
        else:
            key, _, val = line.partition('=')
            key = key.strip()
            val = val.strip()
            parsed: object
            try:
                parsed = int(val)
            except ValueError:
                try:
                    parsed = float(val)
                except ValueError:
                    if ',' in val:
                        items = [v.strip() for v in val.split(',')]
                        try:
                            parsed = [int(v) for v in items]
                        except ValueError:
                            try:
                                parsed = [float(v) for v in items]
                            except ValueError:
                                parsed = items
                    else:
                        parsed = val
            sections[-1][key] = parsed
    return sections


def _aslist(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


_DN_ACTS = {
    'leaky': lambda x: F.leaky_relu(x, 0.1),
    'mish': lambda x: x * torch.tanh(F.softplus(x)),
    'swish': F.silu,
    'logistic': torch.sigmoid,
    'linear': lambda x: x,
}


class DarknetModule(nn.Module):
    """Executes a parsed Darknet cfg on NHWC input; returns the yolo-head
    feature maps (NHWC, float32) in cfg order."""

    def __init__(self, sections, dtype=torch.float32, in_channels=3):
        super().__init__()
        self.layers = [s for s in sections if s['type'] != 'net']
        self.dtype = dtype
        for sec in self.layers:
            if sec['type'] not in ('convolutional', 'route', 'shortcut',
                                   'upsample', 'maxpool', 'yolo'):
                raise ValueError(f'Unsupported darknet layer: {sec["type"]}')
        for i, sec, c_in in _conv_layers(self.layers, in_channels):
            filters = int(sec['filters'])
            bn = int(sec.get('batch_normalize', 0))
            self.add_module(f'conv{i}', Conv(
                c_in, filters, int(sec.get('size', 1)),
                int(sec.get('stride', 1)),
                'SAME' if int(sec.get('pad', 0)) else 'VALID',
                int(sec.get('groups', 1)), bias=not bn, dtype=dtype))
            if bn:
                self.add_module(f'bn{i}', BatchNorm(filters))
        # conv index -> parallel.streams.ChannelShard, set by
        # shard_conv_channels: the conv holds a block of its output
        # channels, gathered after its activation
        self.channel_shards = {}

    def stem_layers(self, h: int, w: int) -> int:
        """How many leading convs the JAX package folds to space-to-depth
        for an (h, w) input (``DarknetModule._stem_plan``): a tiny-style
        3x3/2 stem, or a 3x3/1 then 3x3/2 pair whose first output no
        route or shortcut reads; 0 on an odd input size."""
        if h % 2 or w % 2:
            return 0

        def plain_conv(sec, stride):
            return (sec['type'] == 'convolutional'
                    and int(sec.get('size', 1)) == 3
                    and int(sec.get('stride', 1)) == stride
                    and int(sec.get('groups', 1)) == 1
                    and int(sec.get('pad', 0)) == 1
                    and int(sec.get('batch_normalize', 0)) == 1)

        layers = self.layers
        if layers and plain_conv(layers[0], 2):
            return 1
        refd = set()
        for i, sec in enumerate(layers):
            if sec['type'] == 'route':
                refd.update(i + l if l < 0 else l
                            for l in _aslist(sec['layers']))
            elif sec['type'] == 'shortcut':
                frm = int(sec['from'])
                refd.add(i + frm if frm < 0 else frm)
        if len(layers) > 1 and plain_conv(layers[0], 1) and \
                plain_conv(layers[1], 2) and 0 not in refd:
            return 2
        return 0

    def forward(self, x):
        outputs, heads = [], []
        n_stem = self.stem_layers(x.shape[1], x.shape[2])
        for i, sec in enumerate(self.layers):
            t = sec['type']
            if t == 'convolutional':
                shard = self.channel_shards.get(i)
                if shard is not None and shard.in_slice is not None:
                    x = x[..., shard.in_slice]
                y = getattr(self, f'conv{i}')(x, f32_sum=i < n_stem)
                if int(sec.get('batch_normalize', 0)):
                    y = getattr(self, f'bn{i}')(y)
                x = _DN_ACTS[sec.get('activation', 'linear')](y)
                if shard is not None:
                    x = shard.gather(x)
            elif t == 'shortcut':
                frm = int(sec['from'])
                x = x + outputs[i + frm if frm < 0 else frm]
                x = _DN_ACTS[sec.get('activation', 'linear')](x)
            elif t == 'route':
                idxs = [i + l if l < 0 else l for l in _aslist(sec['layers'])]
                feats = [outputs[j] for j in idxs]
                x = feats[0] if len(feats) == 1 else torch.cat(feats, -1)
                g = int(sec.get('groups', 1))
                if g > 1:
                    gid = int(sec.get('group_id', 0))
                    c = x.shape[-1] // g
                    x = x[..., gid * c:(gid + 1) * c]
            elif t == 'upsample':
                s = int(sec.get('stride', 2))
                x = x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
            elif t == 'maxpool':
                size = int(sec.get('size', 2))
                stride = int(sec.get('stride', size))
                x = max_pool_same(x, size, stride)
            elif t == 'yolo':
                heads.append(x.float())
            outputs.append(x)
        return heads


def yolo_meta_from_cfg(sections) -> dict:
    """Decode metadata (anchors per head, scales, new_coords, classes,
    input shape) from the parsed cfg."""
    net = next(s for s in sections if s['type'] == 'net')
    yolos = [s for s in sections if s['type'] == 'yolo']
    if not yolos:
        raise AssertionError('cfg has no yolo sections')
    anchors = []
    for y in yolos:
        flat = _aslist(y['anchors'])
        anchors.append([a for m in _aslist(y['mask'])
                        for a in (flat[2 * m], flat[2 * m + 1])])
    return {
        'num_classes': int(yolos[0]['classes']),
        'input_shape': (3, int(net['height']), int(net['width'])),
        'anchors': anchors,
        'scales': [float(y.get('scale_x_y', 1.0)) for y in yolos],
        'new_coords': bool(yolos[0].get('new_coords', 0)),
    }


def _conv_layers(sections, in_channels=3):
    """``(i, section, c_in)`` of every convolutional layer, in cfg order."""
    layers = [s for s in sections if s['type'] != 'net']
    prev_c, channels = in_channels, []
    for i, sec in enumerate(layers):
        if sec['type'] == 'convolutional':
            yield i, sec, prev_c
            prev_c = int(sec['filters'])
        elif sec['type'] == 'route':
            idxs = [i + l if l < 0 else l for l in _aslist(sec['layers'])]
            prev_c = sum(channels[j] for j in idxs) // \
                int(sec.get('groups', 1))
        channels.append(prev_c)


def load_darknet_weights(sections, weights_path):
    """A Darknet ``.weights`` file as a ``DarknetModule`` state dict.

    Layout (yolo2onnx.py's WeightLoader): a 5 x int32 header, then per
    convolutional layer in cfg order either the BN's beta, gamma, mean and
    var or the conv bias, then the OIHW kernel. Returns ``(state_dict,
    header)``; raises ``AssertionError``, as the JAX loader does, when the
    file ends early or holds floats the cfg does not consume."""
    buf = Path(weights_path).read_bytes()
    header = np.frombuffer(buf[:20], dtype=np.int32)
    data = np.frombuffer(buf[20:], dtype=np.float32)
    pos = 0

    def take(*shape):
        nonlocal pos
        n = int(np.prod(shape))
        out = data[pos:pos + n]
        if len(out) != n:
            raise AssertionError('weights file exhausted early')
        pos += n
        return torch.from_numpy(out.reshape(shape).copy())

    sd = {}
    for i, sec, c_in in _conv_layers(sections):
        f = int(sec['filters'])
        k = int(sec.get('size', 1))
        if int(sec.get('batch_normalize', 0)):
            for leaf in ('bias', 'weight', 'running_mean', 'running_var'):
                sd[f'bn{i}.{leaf}'] = take(f)
        else:
            sd[f'conv{i}.bias'] = take(f)
        sd[f'conv{i}.weight'] = take(f, c_in // int(sec.get('groups', 1)),
                                     k, k)
    if pos != len(data):
        raise AssertionError(
            f'weights file has {len(data) - pos} unconsumed floats')
    return sd, header


def count_weight_floats(sections) -> int:
    """Number of float32 values a Darknet .weights file holds for this cfg
    (bn: 4 vectors + kernel; else bias + kernel), the layout
    ``load_darknet_weights`` consumes."""
    total = 0
    for _, sec, c_in in _conv_layers(sections):
        f = int(sec['filters'])
        k = int(sec.get('size', 1))
        total += f + 3 * f * int(sec.get('batch_normalize', 0))
        total += f * (c_in // int(sec.get('groups', 1))) * k * k
    return total


def yolo_from_cfg(cfg_path, weights_path=None):
    """A runnable ``(module, meta)`` pair from a Darknet cfg and, if given,
    its ``.weights``; otherwise the weights are a random init (seed 0).
    ``meta`` feeds ``models.yolo.decode_heads``."""
    from .layers import random_init_
    sections = parse_cfg(Path(cfg_path).read_text())
    meta = yolo_meta_from_cfg(sections)
    module = DarknetModule(sections).requires_grad_(False)
    if weights_path is None:
        random_init_(module, torch.Generator().manual_seed(0))
    else:
        module.load_state_dict(load_darknet_weights(sections,
                                                    weights_path)[0])
    return module, meta
