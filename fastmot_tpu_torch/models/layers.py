"""Layers shared by the port's networks, on NHWC tensors.

The JAX package's convolutions, pools and batch norms are Flax layers;
these reproduce their semantics in torch:

- ``padding='SAME'`` is Flax/XLA's: the total pad ``max((out - 1) * s + k
  - in, 0)`` is split with the smaller half first, so a 3x3/2 conv on an
  even input pads (0, 1) and a 7x7/2 conv (2, 3) where torch's symmetric
  ``padding=`` would shift every value. The pad is applied with ``F.pad``.
- ``BatchNorm`` is Flax's inference form ``(x - mean) * (rsqrt(var + eps)
  * scale) + bias`` computed in float32 and cast to the layer's dtype.
- A conv with a compute dtype casts input and kernel to it, and adds its
  bias in that dtype after the conv, as ``nn.Conv(dtype=...)`` does.
- ``DepthwiseConv3x3`` is the JAX package's shifted-tap depthwise layer:
  pad (1, 1), nine bf16 products each cast to f32 and summed in f32, then
  every ``stride``-th output. Its stride-2 outputs sit where a symmetric
  ``padding=1`` conv puts them, not where 'SAME' (0, 1) would.
- Pools are Flax's 'SAME' pools: max pads with -inf, average pads with
  zeros and divides by the full window (``count_include_pad=True``).

Random init is seeded through an explicit ``torch.Generator``: convs and
dense layers lecun-normal (truncated at two standard deviations), BN at
identity, biases zero, as Flax's defaults.

Tensor parallelism over the mesh's ``'model'`` axis
(``parallel.shard_conv_channels``) gives a layer a ``shard``: the layer
then holds one block of its output channels. A conv or dense layer
computes that block from its whole input; a per-channel layer (BN,
depthwise, a grouped conv) takes its block of a whole input itself and
passes a block it is handed. The network that owns the chain calls
``gather`` after the chain's last per-channel op.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA 'SAME' padding (before, after) along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """Pad an NHWC tensor for a k x k window with stride s, 'SAME'."""
    top, bottom = same_pads(x.shape[1], k, s)
    left, right = same_pads(x.shape[2], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom), value=value)
    return x


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def gather(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on the channel axis: ``layer``'s blocks all-gathered
    over ``'model'`` when it is sharded, else ``x`` itself."""
    shard = getattr(layer, 'shard', None)
    return x if shard is None else shard.gather(x)


def _own_block(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return x if layer.shard is None else layer.shard.take(x)


class Conv(nn.Module):
    """k x k conv on NHWC input; weight OIHW (``groups`` as torch)."""
    shard = None

    def __init__(self, cin, cout, k=1, stride=1, padding='SAME', groups=1,
                 bias=False, dtype=torch.float32):
        super().__init__()
        self.k, self.stride, self.padding, self.groups = k, stride, padding, \
            groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, f32_sum=False):
        """``f32_sum``: round input and kernel to ``dtype`` but keep the
        float32 sum of their products (``preferred_element_type=f32``)."""
        x = _own_block(self, x)
        if self.padding == 'SAME':
            x = pad_same(x, self.k, self.stride)
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if f32_sum:
            x, w = x.float(), w.float()
        y = nhwc(F.conv2d(nchw(x), w, stride=self.stride,
                          groups=self.groups))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class DepthwiseConv3x3(nn.Module):
    """3x3 depthwise conv on NHWC input; weight ``[C, 1, 3, 3]``; bf16 out.

    Each tap's product is rounded to bf16 before the f32 sum, as in the
    Flax layer, so the two agree to the last bit of the f32 sum order."""
    shard = None

    def __init__(self, c, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(c, 1, 3, 3))

    def forward(self, x):
        x = _own_block(self, x)
        s = self.stride
        h, w = x.shape[1], x.shape[2]
        xp = F.pad(x.to(torch.bfloat16), (0, 0, 1, 1, 1, 1))
        wt = self.weight.to(torch.bfloat16)
        out = None
        for dy in range(3):
            for dx in range(3):
                tap = (xp[:, dy:dy + h:s, dx:dx + w:s, :]
                       * wt[:, 0, dy, dx]).float()
                out = tap if out is None else out + tap
        return out.to(torch.bfloat16)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """k x k max pool with stride s on NHWC input, Flax 'SAME'."""
    xp = pad_same(x, k, s, value=-float('inf'))
    return nhwc(F.max_pool2d(nchw(xp), k, s))


def avg_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """k x k average pool with stride s on NHWC input, Flax 'SAME': the
    zero padding counts in the divisor."""
    return nhwc(F.avg_pool2d(nchw(pad_same(x, k, s)), k, s))


class BatchNorm(nn.Module):
    """Inference batch norm over the last axis, Flax's arithmetic."""
    shard = None

    def __init__(self, c, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x):
        x = _own_block(self, x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(self.dtype)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator):
    """Flax-default random init, drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, (Conv, DepthwiseConv3x3, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            # truncated normal by inverse CDF, as torch 2.11's
            # nn.init.trunc_normal_ draws it; torch 2.13's redraws rejected
            # values, which gives other weights for a seed and takes 5x as
            # long (9 s against 1.7 s for YOLOv4-P6's 127M weights)
            b = math.erf(math.sqrt(2.0))
            w.uniform_(-b, b, generator=generator).erfinv_() \
                .mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
            if getattr(m, 'bias', None) is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
