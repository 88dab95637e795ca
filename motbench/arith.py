"""The benchmark's arithmetic: the H100's published peaks, network FLOPs
from shapes, the OSBlock kernel's least time, the device's busy time from
kernel intervals, and the statistics the metrics report.

Nothing here imports the program: the FLOPs come from the reference
networks run on meta tensors, and the OSBlock's packed weight bytes from a
frozen copy of the port's packing arithmetic.
"""
from __future__ import annotations

import math
import statistics

import torch

# one H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores, float32 on
# the CUDA cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError('percentile of no values')
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def quartile_spread(values) -> float:
    """The distance between the first and third quartile over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError('a rate over no time')
    return count / seconds


def busy_seconds(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps ``(start, end)`` in ``[lo, hi]`` that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def detector_macs(sections, input_hw) -> int:
    """Multiply-accumulates of one frame through the Darknet network."""
    from .reference.detect import darknet_forward
    count = [0]
    sd = _meta_darknet_weights(sections)
    darknet_forward(sections, sd, torch.empty((1, 3) + tuple(input_hw),
                                              device='meta'), count)
    return count[0]


def _meta_darknet_weights(sections):
    layers = [s for s in sections if s['type'] != 'net']
    sd, prev, chans = {}, 3, []
    for i, sec in enumerate(layers):
        if sec['type'] == 'convolutional':
            f, k = int(sec['filters']), int(sec.get('size', 1))
            g = int(sec.get('groups', 1))
            sd[f'conv{i}.weight'] = torch.empty((f, prev // g, k, k),
                                                device='meta')
            for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
                sd[f'bn{i}.{leaf}'] = torch.empty(f, device='meta')
            sd[f'conv{i}.bias'] = torch.empty(f, device='meta')
            prev = f
        elif sec['type'] == 'route':
            idx = sec['layers'] if isinstance(sec['layers'], list) \
                else [sec['layers']]
            prev = sum(chans[i + j if j < 0 else j] for j in idx) \
                // int(sec.get('groups', 1))
        chans.append(prev)
    return sd


def osnet_macs(channels, feature_dim, input_hw) -> int:
    """Multiply-accumulates of one crop through OSNet."""
    from .reference.reid import osnet_forward
    sd = _meta_osnet_weights(channels, feature_dim)
    count = [0]
    osnet_forward(sd, torch.empty((1, 3) + tuple(input_hw), device='meta'),
                  channels, count)
    return count[0]


def _meta_osnet_weights(c, feature_dim):
    sd = {}

    def vec(prefix, n):
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            sd[f'{prefix}.{leaf}'] = torch.empty(n, device='meta')

    def convbn(prefix, cin, cout, k=1):
        sd[f'{prefix}.Conv_0.weight'] = torch.empty((cout, cin, k, k),
                                                    device='meta')
        vec(f'{prefix}.BatchNorm_0', cout)

    def linear(prefix, cin, cout):
        sd[f'{prefix}.weight'] = torch.empty((cout, cin), device='meta')
        sd[f'{prefix}.bias'] = torch.empty(cout, device='meta')

    convbn('ConvBNReLU_0', 3, c[0], 7)
    n_conv, n_blk, prev = 1, 0, c[0]
    for stage, ch in enumerate(c[1:]):
        for _ in range(2):
            p = f'OSBlock_{n_blk}'
            mid = max(ch // 4, 4)
            convbn(f'{p}.ConvBNReLU_0', prev, mid)
            for i in range(10):
                convbn(f'{p}.LiteConv_{i}', mid, mid)
                sd[f'{p}.LiteConv_{i}.DepthwiseConv3x3_0.weight'] = \
                    torch.empty((mid, 1, 3, 3), device='meta')
            linear(f'{p}.AggregationGate_0.Dense_0', mid, max(mid // 16, 1))
            linear(f'{p}.AggregationGate_0.Dense_1', max(mid // 16, 1), mid)
            convbn(f'{p}.ConvBNReLU_1', mid, ch)
            if prev != ch:
                convbn(f'{p}.ConvBNReLU_2', prev, ch)
            n_blk += 1
            prev = ch
        if stage < len(c) - 2:
            convbn(f'ConvBNReLU_{n_conv}', ch, ch)
            n_conv += 1
    convbn(f'ConvBNReLU_{n_conv}', c[-1], c[-1])
    linear('Dense_0', c[-1], feature_dim)
    vec('BatchNorm_0', feature_dim)
    return sd


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def osblock_packed_bytes(cin: int, features: int) -> int:
    """Bytes of one OSBlock's packed weights as the kernel reads them: the
    1x1 matrices as bf16 tiles with K padded to 16, every other tensor as
    float32 (a frozen copy of ``ops/osnet_block.py``'s ``_shapes`` and
    ``weight_counts``)."""
    mid = max(features // 4, 4)
    hid = max(mid // 16, 1)
    mats = [(cin, mid)] + [(mid, mid)] * 10 + [(mid, features)]
    vecs = 2 * mid + 10 * (9 * mid + 2 * mid) + (mid * hid + hid
                                                 + hid * mid + mid) \
        + 2 * features
    if cin != features:
        mats.append((cin, features))
        vecs += 2 * features
    return 2 * sum(_round16(k) * n for k, n in mats) + 4 * vecs


def osblock_bound_ms(batch, h, w, cin, features) -> float:
    """The least time an H100 could take for one OSBlock call (a frozen
    copy of ``chip_smoke.py``'s ``osblock_bound_ms``): each input byte
    read once (x, the packed weights) and each output byte written once,
    over 3.35 TB/s, against the 1x1 convs' FLOPs over 989 TFLOP/s plus
    the depthwise, BN, gated-sum and residual FLOPs over 67 TFLOP/s."""
    mid = max(features // 4, 4)
    px = batch * h * w
    ds = cin != features
    mm = 2 * px * (cin * mid + 10 * mid * mid + mid * features
                   + (cin * features if ds else 0))
    f32 = px * (mid * (10 * 18 + 11 * 2 + 7)
                + features * (2 + (2 if ds else 0) + 1))
    nbytes = px * (cin + features) * 2 + osblock_packed_bytes(cin, features)
    return max((mm / PEAK_BF16 + f32 / PEAK_F32) * 1e3,
               nbytes / PEAK_BYTES * 1e3)


def osnet_block_shapes(channels, input_hw):
    """(h, w, cin, features) of each OSBlock call of OSNet, in order."""
    h, w = input_hw
    h, w = -(-h // 2), -(-w // 2)         # conv1 7x7/2
    h, w = -(-h // 2), -(-w // 2)         # max pool 3x3/2
    out, prev = [], channels[0]
    for stage, ch in enumerate(channels[1:]):
        for _ in range(2):
            out.append((h, w, prev, ch))
            prev = ch
        if stage < len(channels) - 2:
            h, w = h // 2, w // 2         # 2x2/2 average pool
    return out
