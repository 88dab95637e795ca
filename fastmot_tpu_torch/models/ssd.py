"""SSD detector family as torch modules (port of
``fastmot_tpu/models/ssd.py``).

SSDInceptionV2, SSDMobileNetV1 and SSDMobileNetV2: a backbone and the SSD
multibox head over six scales, 300x300 inputs, 91 COCO classes (class 0
background). Module names are Flax's (``ConvBNReLU6_<n>/Conv_0``,
``.../DepthwiseConv3x3_0``, ``SSDHead_0/Conv_<n>``, the TF-slim layer
paths of the Inception blocks with '/' -> '__'), so the JAX package's
parameters and converted frozen graphs (``ssd_convert``) load by name.

Numerics follow the Flax modules: convs in bf16, batch norm in f32 (eps
1e-3 in ``ConvBNReLU6``, Flax's 1e-5 in the inverted residual's
projection), so a ``ConvBNReLU6`` output is f32; depthwise convs are the
shifted-tap ``DepthwiseConv3x3``; the head's predictor convs run in f32
with bias. ``generate_anchors`` (GridAnchor_TRT's role) and ``decode_ssd``
(the top-k that NMS_TRT emitted) complete the graph; rows are ``[image_id,
label, conf, x1, y1, x2, y2]`` normalised to [0, 1].
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import (BatchNorm, Conv, DepthwiseConv3x3, avg_pool_same,
                     gather, max_pool_same)
from .registry import SSDModel, register_ssd

BF16 = torch.bfloat16


class ConvBNReLU6(nn.Module):
    """Conv (or 3x3 depthwise) -> f32 BN -> ReLU6."""

    def __init__(self, cin, features, kernel=3, stride=1, depthwise=False,
                 bn_eps=1e-3):
        super().__init__()
        self.depthwise = depthwise
        if depthwise:
            self.DepthwiseConv3x3_0 = DepthwiseConv3x3(cin, stride)
            features = cin
        else:
            self.Conv_0 = Conv(cin, features, kernel, stride, dtype=BF16)
        self.BatchNorm_0 = BatchNorm(features, eps=bn_eps)

    def forward(self, x, whole=True):
        """``whole=False`` leaves a sharded output as this rank's channel
        block, for a per-channel layer that follows."""
        conv = self.DepthwiseConv3x3_0 if self.depthwise else self.Conv_0
        y = torch.clamp(self.BatchNorm_0(conv(x)), 0.0, 6.0)
        return gather(conv, y) if whole else y


def _named(module, prefix, layers):
    for i, layer in enumerate(layers):
        module.add_module(f'{prefix}_{i}', layer)


class MobileNetV1Backbone(nn.Module):
    """Depthwise-separable trunk; returns Conv2d_11 (19x19, 512) and
    Conv2d_13 (10x10, 1024) at a 300x300 input."""
    C_MID, C_TOP = 512, 1024
    MID_LAYER = 22          # the pointwise conv of the eleventh pair

    def __init__(self):
        super().__init__()
        layers, cin = [ConvBNReLU6(3, 32, 3, 2)], 32
        plan = ([(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)]
                + [(512, 1)] * 5 + [(1024, 2), (1024, 1)])
        for feats, s in plan:
            layers += [ConvBNReLU6(cin, 0, 3, s, depthwise=True),
                       ConvBNReLU6(cin, feats, 1)]
            cin = feats
        _named(self, 'ConvBNReLU6', layers)

    def forward(self, x):
        for i, layer in enumerate(self.children()):
            x = layer(x)
            if i == self.MID_LAYER:
                c_mid = x
        return c_mid, x


class InvertedResidual(nn.Module):
    def __init__(self, cin, features, stride=1, expand=6):
        super().__init__()
        mid = cin * expand
        layers = [ConvBNReLU6(cin, mid, 1)] if expand > 1 else []
        layers.append(ConvBNReLU6(mid, 0, 3, stride, depthwise=True))
        _named(self, 'ConvBNReLU6', layers)
        self.n_cbr = len(layers)
        self.Conv_0 = Conv(mid, features, 1, dtype=BF16)
        self.BatchNorm_0 = BatchNorm(features)       # Flax's eps 1e-5
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = x
        for i in range(self.n_cbr):
            # the expansion's channel block feeds the depthwise as it is
            h = getattr(self, f'ConvBNReLU6_{i}')(h, i == self.n_cbr - 1)
        h = gather(self.Conv_0, self.BatchNorm_0(self.Conv_0(h)))
        return h + x if self.residual else h


class MobileNetV2Backbone(nn.Module):
    """Returns the 19x19 expansion point (96 ch) and the 10x10 1280-ch
    top at a 300x300 input."""
    C_MID, C_TOP = 96, 1280
    MID_BLOCK = 12          # the last 96-channel block

    def __init__(self):
        super().__init__()
        self.ConvBNReLU6_0 = ConvBNReLU6(3, 32, 3, 2)
        blocks, cin = [InvertedResidual(32, 16, 1, 1)], 16
        for feats, n, s in [(24, 2, 2), (32, 3, 2), (64, 4, 2), (96, 3, 1),
                            (160, 3, 2), (320, 1, 1)]:
            for i in range(n):
                blocks.append(InvertedResidual(cin, feats, s if i == 0 else 1))
                cin = feats
        _named(self, 'InvertedResidual', blocks)
        self.n_blocks = len(blocks)
        self.ConvBNReLU6_1 = ConvBNReLU6(320, 1280, 1)

    def forward(self, x):
        x = self.ConvBNReLU6_0(x)
        for i in range(self.n_blocks):
            x = getattr(self, f'InvertedResidual_{i}')(x)
            if i == self.MID_BLOCK:
                c_mid = x
        return c_mid, self.ConvBNReLU6_1(x)


# TF-slim inception_v2 block table (slim/nets/inception_v2.py), as in the
# JAX package. Normal blocks: Branch_0 1x1, Branch_1 1x1->3x3, Branch_2
# 1x1->3x3->3x3, Branch_3 pool->1x1. Reduction blocks ('red'): Branch_0
# 1x1->3x3(s2), Branch_1 1x1->3x3->3x3(s2), Branch_2 max-pool(s2).
INCEPTION_V2_BLOCKS = (
    ('Mixed_3b', {'b0': 64, 'b1': (64, 64), 'b2': (64, 96),
                  'pool': ('avg', 32)}),
    ('Mixed_3c', {'b0': 64, 'b1': (64, 96), 'b2': (64, 96),
                  'pool': ('avg', 64)}),
    ('Mixed_4a', {'red': True, 'b0': (128, 160), 'b1': (64, 96)}),
    ('Mixed_4b', {'b0': 224, 'b1': (64, 96), 'b2': (96, 128),
                  'pool': ('avg', 128)}),
    ('Mixed_4c', {'b0': 192, 'b1': (96, 128), 'b2': (96, 128),
                  'pool': ('avg', 128)}),
    ('Mixed_4d', {'b0': 160, 'b1': (128, 160), 'b2': (128, 160),
                  'pool': ('avg', 96)}),
    ('Mixed_4e', {'b0': 96, 'b1': (128, 192), 'b2': (160, 192),
                  'pool': ('avg', 96)}),
    ('Mixed_5a', {'red': True, 'b0': (128, 192), 'b1': (192, 256)}),
    ('Mixed_5b', {'b0': 352, 'b1': (192, 320), 'b2': (160, 224),
                  'pool': ('avg', 128)}),
    ('Mixed_5c', {'b0': 352, 'b1': (192, 320), 'b2': (192, 224),
                  'pool': ('max', 128)}),
)


def _branches(spec):
    """``[(branch, [(conv name, features, kernel, stride), ...]), ...]``
    of one Inception block, without the pools."""
    if spec.get('red'):
        (a0, a1), (c0, c1) = spec['b0'], spec['b1']
        return [('Branch_0', [('Conv2d_0a_1x1', a0, 1, 1),
                              ('Conv2d_1a_3x3', a1, 3, 2)]),
                ('Branch_1', [('Conv2d_0a_1x1', c0, 1, 1),
                              ('Conv2d_0b_3x3', c1, 3, 1),
                              ('Conv2d_1a_3x3', c1, 3, 2)])]
    (c0, c1), (d0, d1) = spec['b1'], spec['b2']
    return [('Branch_0', [('Conv2d_0a_1x1', spec['b0'], 1, 1)]),
            ('Branch_1', [('Conv2d_0a_1x1', c0, 1, 1),
                          ('Conv2d_0b_3x3', c1, 3, 1)]),
            ('Branch_2', [('Conv2d_0a_1x1', d0, 1, 1),
                          ('Conv2d_0b_3x3', d1, 3, 1),
                          ('Conv2d_0c_3x3', d1, 3, 1)]),
            ('Branch_3', [('Conv2d_0b_1x1', spec['pool'][1], 1, 1)])]


class InceptionV2Backbone(nn.Module):
    """TF-slim inception_v2 trunk; returns Mixed_4c (19x19, 576) and
    Mixed_5c (10x10, 1024) at a 300x300 input.

    The stem is slim's separable 7x7/2 (depth multiplier 8) whose
    depthwise half runs as a dense ``[7, 7, 3, 24]`` conv
    (``Conv2d_1a_7x7_depthwise``, no BN), as in the JAX package."""
    C_MID, C_TOP = 576, 1024

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_7x7_depthwise = Conv(3, 24, 7, 2, dtype=BF16)
        self.Conv2d_1a_7x7_pointwise = ConvBNReLU6(24, 64, 1)
        self.Conv2d_2b_1x1 = ConvBNReLU6(64, 64, 1)
        self.Conv2d_2c_3x3 = ConvBNReLU6(64, 192, 3)
        cin = 192
        for name, spec in INCEPTION_V2_BLOCKS:
            cout = cin if spec.get('red') else 0
            for br, convs in _branches(spec):
                c = cin
                for cname, feats, k, s in convs:
                    self.add_module(f'{name}__{br}__{cname}',
                                    ConvBNReLU6(c, feats, k, s))
                    c = feats
                cout += c
            cin = cout

    def _block(self, x, name, spec):
        outs = []
        for br, convs in _branches(spec):
            h = x
            if br == 'Branch_3':
                pool = avg_pool_same if spec['pool'][0] == 'avg' \
                    else max_pool_same
                h = pool(h, 3, 1)
            for cname, *_ in convs:
                h = getattr(self, f'{name}__{br}__{cname}')(h)
            outs.append(h)
        if spec.get('red'):
            outs.append(max_pool_same(x, 3, 2))
        return torch.cat(outs, -1)

    def forward(self, x):
        x = gather(self.Conv2d_1a_7x7_depthwise,
                   self.Conv2d_1a_7x7_depthwise(x))
        x = self.Conv2d_1a_7x7_pointwise(x)
        x = max_pool_same(x, 3, 2)
        x = self.Conv2d_2c_3x3(self.Conv2d_2b_1x1(x))
        x = max_pool_same(x, 3, 2)
        for name, spec in INCEPTION_V2_BLOCKS:
            x = self._block(x, name, spec)
            if name == 'Mixed_4c':
                c_mid = x
        return c_mid, x


class SSDHead(nn.Module):
    """Extra feature layers and the multibox predictors over six scales.

    ``predictor_kernel`` is 1 for ssd_mobilenet_v1_coco and 3 for the
    others, as in the TF Object Detection configs."""

    def __init__(self, num_classes, c_mid, c_top,
                 anchors_per_scale=(3, 6, 6, 6, 6, 6), predictor_kernel=3):
        super().__init__()
        self.num_classes = num_classes
        extras, cin = [], c_top
        for out_ch in (512, 256, 256, 128):
            extras += [ConvBNReLU6(cin, out_ch // 2, 1),
                       ConvBNReLU6(out_ch // 2, out_ch, 3, 2)]
            cin = out_ch
        _named(self, 'ConvBNReLU6', extras)
        preds = []
        for c, a in zip((c_mid, c_top, 512, 256, 256, 128),
                        anchors_per_scale):
            preds += [Conv(c, a * 4, predictor_kernel, bias=True),
                      Conv(c, a * num_classes, predictor_kernel, bias=True)]
        _named(self, 'Conv', preds)

    def forward(self, c_mid, c_top):
        feats, x = [c_mid, c_top], c_top
        for i in range(8):
            x = getattr(self, f'ConvBNReLU6_{i}')(x)
            if i % 2:
                feats.append(x)
        locs, confs = [], []
        for i, f in enumerate(feats):
            loc_conv, conf_conv = (getattr(self, f'Conv_{2 * i + j}')
                                   for j in (0, 1))
            loc = gather(loc_conv, loc_conv(f))
            conf = gather(conf_conv, conf_conv(f))
            locs.append(loc.reshape(loc.shape[0], -1, 4))
            confs.append(conf.reshape(conf.shape[0], -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(confs, 1)


_BACKBONES = {'mobilenet_v1': MobileNetV1Backbone,
              'mobilenet_v2': MobileNetV2Backbone,
              'inception_v2': InceptionV2Backbone}


class SSDNet(nn.Module):
    """Backbone + head: NHWC float32 input in [-1, 1] -> (locs ``[B, N,
    4]``, class logits ``[B, N, num_classes]``), both float32."""

    def __init__(self, backbone, num_classes, predictor_kernel=3):
        super().__init__()
        cls = _BACKBONES[backbone]
        self.backbone = f'{cls.__name__}_0'
        self.add_module(self.backbone, cls())
        self.SSDHead_0 = SSDHead(num_classes, cls.C_MID, cls.C_TOP,
                                 predictor_kernel=predictor_kernel)

    def forward(self, x):
        return self.SSDHead_0(*getattr(self, self.backbone)(x))


def generate_anchors(input_size=300,
                     feature_sizes=(19, 10, 5, 3, 2, 1),
                     anchors_per_scale=(3, 6, 6, 6, 6, 6),
                     min_scale=0.2, max_scale=0.95):
    """TF Object Detection API grid anchors (GridAnchor_TRT's role).

    Returns [num_anchors, 4] (cx, cy, w, h) normalized to [0, 1].
    """
    num_layers = len(feature_sizes)
    scales = [min_scale + (max_scale - min_scale) * i / (num_layers - 1)
              for i in range(num_layers)] + [1.0]
    all_anchors = []
    for idx, (fs, n_a) in enumerate(zip(feature_sizes, anchors_per_scale)):
        s = scales[idx]
        s_next = np.sqrt(s * scales[idx + 1])
        if n_a == 3:
            specs = [(s, 1.0), (s, 2.0), (s, 0.5)]
        else:
            specs = [(s, 1.0), (s, 2.0), (s, 0.5), (s, 3.0),
                     (s, 1.0 / 3.0), (s_next, 1.0)]
        ys, xs = np.meshgrid(np.arange(fs), np.arange(fs), indexing='ij')
        cx = (xs + 0.5) / fs
        cy = (ys + 0.5) / fs
        for scale_a, ar in specs[:n_a]:
            w = scale_a * np.sqrt(ar)
            h = scale_a / np.sqrt(ar)
            a = np.stack([cx, cy, np.full_like(cx, w), np.full_like(cy, h)],
                         axis=-1).reshape(-1, 4)
            all_anchors.append(a)
        # interleave anchors per location the way the head emits them
        per_loc = np.stack(all_anchors[-n_a:], axis=1).reshape(-1, 4)
        del all_anchors[-n_a:]
        all_anchors.append(per_loc)
    return np.concatenate(all_anchors, axis=0).astype(np.float32)


def decode_ssd(locs, confs, anchors, topk, variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode the box regressions and keep each image's ``topk`` best
    boxes: ``[B, topk, 7]`` rows ``[image_id, label, conf, x1, y1, x2,
    y2]``. Ties keep the lower anchor index, as ``lax.top_k`` and
    ``jnp.argmax`` do (a stable descending sort, not ``torch.topk``)."""
    vx, vy, vw, vh = variances
    cx = locs[..., 0] * vx * anchors[None, :, 2] + anchors[None, :, 0]
    cy = locs[..., 1] * vy * anchors[None, :, 3] + anchors[None, :, 1]
    w = torch.exp(locs[..., 2] * vw) * anchors[None, :, 2]
    h = torch.exp(locs[..., 3] * vh) * anchors[None, :, 3]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)

    # class 0 is background in the TF SSD convention
    best_prob, best_cls = torch.max(torch.softmax(confs, -1)[..., 1:], -1)
    top_prob, top_idx = torch.sort(best_prob, dim=1, descending=True,
                                   stable=True)
    top_prob, top_idx = top_prob[:, :topk], top_idx[:, :topk]
    b = locs.shape[0]
    batch_ids = torch.arange(b, dtype=torch.float32,
                             device=locs.device)[:, None].expand(b, topk)
    label = torch.gather(best_cls + 1, 1, top_idx).to(torch.float32)
    box = torch.gather(boxes, 1, top_idx[..., None].expand(b, topk, 4))
    return torch.cat([batch_ids[..., None], label[..., None],
                      top_prob[..., None], box], -1)


class _SSDBase(SSDModel):
    INPUT_SHAPE = (3, 300, 300)
    NUM_CLASSES = 91
    BACKBONE = 'mobilenet_v1'
    PREDICTOR_KERNEL = 3

    @classmethod
    def build(cls):
        return SSDNet(cls.BACKBONE, cls.NUM_CLASSES, cls.PREDICTOR_KERNEL)


@register_ssd
class SSDInceptionV2(_SSDBase):
    BACKBONE = 'inception_v2'


@register_ssd
class SSDMobileNetV1(_SSDBase):
    BACKBONE = 'mobilenet_v1'
    PREDICTOR_KERNEL = 1


@register_ssd
class SSDMobileNetV2(_SSDBase):
    BACKBONE = 'mobilenet_v2'
