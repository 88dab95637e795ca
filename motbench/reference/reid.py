"""Plain float32 reference of the ReID stage: each box's crop of its
stream's frame resized to the network input, ImageNet normalisation, OSNet
and the L2 norm.

The crop takes the box's corners floored and clamped to >= 0, both
inclusive, and samples it bilinearly with half-pixel centres and edge
clamping, in float32 (the port rounds its taps to bf16, as the JAX
package's matrix products do; the configuration's precision is bf16).
OSNet (Zhou et al., "Omni-Scale Feature Learning for Person
Re-Identification", ICCV 2019; the x0.25 widths) runs in float32 from the
raw weights, every batch norm unfolded, with the same module names as the
port's and the JAX package's Flax modules, so one state dict feeds both.
``counter`` counts multiply-accumulates as in ``detect.darknet_forward``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .detect import _same, batch_norm, conv

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def crops(frames_u8, tlbrs, out_hw):
    """frames [S, H, W, 3] uint8 BGR, boxes [S, D, 4] -> [S * D, 3, oh,
    ow] float32 RGB, normalised."""
    s, fh, fw = frames_u8.shape[:3]
    oh, ow = out_hw
    dev = frames_u8.device
    boxes = torch.clamp(torch.floor(tlbrs.reshape(-1, 4).float()), min=0.0)
    sid = torch.arange(s, device=dev).repeat_interleave(tlbrs.shape[1])
    x0, y0 = boxes[:, 0], boxes[:, 1]
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    us = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    vs = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    xs = torch.clamp(x0[:, None] + us * w[:, None] - 0.5, 0.0, fw - 1.0)
    ys = torch.clamp(y0[:, None] + vs * h[:, None] - 0.5, 0.0, fh - 1.0)

    def taps(pos, n):
        i0 = torch.floor(pos)
        frac = pos - i0
        i0 = i0.long()
        return i0, torch.clamp(i0 + 1, max=n - 1), 1.0 - frac, frac

    xi0, xi1, wx0, wx1 = taps(xs, fw)
    yi0, yi1, wy0, wy1 = taps(ys, fh)
    img = frames_u8.float()
    b = sid[:, None, None]

    def rows(yi):
        r = yi[:, :, None]
        return wx0[:, None, :, None] * img[b, r, xi0[:, None, :]] \
            + wx1[:, None, :, None] * img[b, r, xi1[:, None, :]]

    out = wy0[:, :, None, None] * rows(yi0) + wy1[:, :, None, None] \
        * rows(yi1)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    out = (out.flip(-1) / 255.0 - mean) / std
    return out.permute(0, 3, 1, 2)


def _conv_bn(x, sd, prefix, stride=1, relu=True, counter=None):
    x = conv(x, sd[f'{prefix}.Conv_0.weight'], stride, counter=counter)
    x = batch_norm(x, sd, f'{prefix}.BatchNorm_0')
    return torch.relu(x) if relu else x


def _lite(x, sd, prefix, counter):
    x = conv(x, sd[f'{prefix}.Conv_0.weight'], counter=counter)
    dw = sd[f'{prefix}.DepthwiseConv3x3_0.weight']
    x = F.conv2d(F.pad(x, (1, 1, 1, 1)), dw, groups=dw.shape[0])
    if counter is not None:
        counter[0] += x.numel() * 9
    return torch.relu(batch_norm(x, sd, f'{prefix}.BatchNorm_0'))


def _linear(v, sd, prefix, counter):
    w = sd[f'{prefix}.weight']
    if counter is not None:
        counter[0] += v.shape[0] * w.numel()
    return v @ w.t() + sd[f'{prefix}.bias']


def _gate(x, sd, prefix, counter):
    v = x.mean(dim=(2, 3))
    g = torch.relu(_linear(v, sd, f'{prefix}.Dense_0', counter))
    g = torch.sigmoid(_linear(g, sd, f'{prefix}.Dense_1', counter))
    return x * g[:, :, None, None]


def _osblock(x, sd, prefix, cin, features, counter):
    y = _conv_bn(x, sd, f'{prefix}.ConvBNReLU_0', counter=counter)
    lite = iter(range(10))
    out = 0
    for t in range(1, 5):
        s = y
        for _ in range(t):
            s = _lite(s, sd, f'{prefix}.LiteConv_{next(lite)}', counter)
        out = out + _gate(s, sd, f'{prefix}.AggregationGate_0', counter)
    out = _conv_bn(out, sd, f'{prefix}.ConvBNReLU_1', relu=False,
                   counter=counter)
    identity = x if cin == features else _conv_bn(
        x, sd, f'{prefix}.ConvBNReLU_2', relu=False, counter=counter)
    return torch.relu(out + identity)


def osnet_forward(sd, x, channels, counter=None):
    """OSNet on NCHW float ``x`` -> L2-normalised [B, feature_dim]
    embeddings: conv1 7x7/2, max pool 3x3/2, three stages of two OSBlocks
    with 1x1 + 2x2 average-pool transitions after the first two, conv5,
    global average pool, fc (linear, BN, ReLU)."""
    c = channels
    x = _conv_bn(x, sd, 'ConvBNReLU_0', stride=2, counter=counter)
    x = F.max_pool2d(_same(x, 3, 2, -float('inf')), 3, 2)
    n_conv, n_blk, prev = 1, 0, c[0]
    for stage, ch in enumerate(c[1:]):
        for _ in range(2):
            x = _osblock(x, sd, f'OSBlock_{n_blk}', prev, ch, counter)
            n_blk += 1
            prev = ch
        if stage < len(c) - 2:
            x = _conv_bn(x, sd, f'ConvBNReLU_{n_conv}', counter=counter)
            x = F.avg_pool2d(x, 2, 2)
            n_conv += 1
    x = _conv_bn(x, sd, f'ConvBNReLU_{n_conv}', counter=counter)
    v = x.mean(dim=(2, 3))
    v = _linear(v, sd, 'Dense_0', counter)
    v = torch.relu(batch_norm(v, sd, 'BatchNorm_0'))
    norm = torch.linalg.norm(v, dim=1, keepdim=True)
    return v / torch.where(norm > 0, norm, torch.ones_like(norm))
