"""OSNet ReID networks as torch modules (port of
``fastmot_tpu/models/osnet.py``).

Same layer sequence and the same module names as the Flax modules, so the
JAX package's parameters load by name (``weights.py``). Activations are
NHWC and bf16 through the trunk, as in Flax. Every ``OSBlock`` runs through
``ops.osnet_block.osblock``: the CUDA kernel on the card, its plain torch
version on the CPU (what the JAX package's ``apply_fused`` does with the
Pallas kernel). Under ``force_plain_streams`` it takes the Flax module's
literal per-stream forward instead: one call per LiteConv, conv, BN and
gate, which ``models.quantize`` hooks. Under ``'model'`` sharding an
``OSBlock`` all-gathers its weights and runs whole on every rank (what
XLA does for a ``pallas_call`` whose operands are sharded); the stem, the
transitions, conv5 and the embedding head run on channel blocks.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.osnet_block import fold_osblock, osblock, pack_osblock
from .layers import BatchNorm, Conv, DepthwiseConv3x3, gather, max_pool_same
from .registry import ReIDModel, register_reid

BF16 = torch.bfloat16

_PLAIN_STREAMS = contextvars.ContextVar('osnet_plain_streams', default=False)


@contextlib.contextmanager
def force_plain_streams():
    """OSBlocks run their literal per-stream forward in this context, not
    the OSBlock kernel (the JAX package's ``force_plain_streams``)."""
    tok = _PLAIN_STREAMS.set(True)
    try:
        yield
    finally:
        _PLAIN_STREAMS.reset(tok)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, relu=True):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, stride, dtype=BF16)
        self.BatchNorm_0 = BatchNorm(cout, dtype=BF16)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return gather(self.Conv_0, torch.relu(x) if self.relu else x)


class LiteConv(nn.Module):
    """Depthwise-separable 3x3: 1x1 bf16 conv, shifted-tap depthwise, bf16
    BN, ReLU (inside the OSBlock kernel on its main path)."""

    def __init__(self, c):
        super().__init__()
        self.Conv_0 = Conv(c, c, 1, dtype=BF16)
        self.DepthwiseConv3x3_0 = DepthwiseConv3x3(c)
        self.BatchNorm_0 = BatchNorm(c, dtype=BF16)

    def forward(self, x):
        x = self.DepthwiseConv3x3_0(self.Conv_0(x))
        return torch.relu(self.BatchNorm_0(x))


class AggregationGate(nn.Module):
    """Channel gate shared by the four streams: the bf16 mean of the map,
    two f32 dense layers, a sigmoid; the gated map is f32."""

    def __init__(self, c, reduction=16):
        super().__init__()
        self.Dense_0 = nn.Linear(c, max(c // reduction, 1))
        self.Dense_1 = nn.Linear(max(c // reduction, 1), c)

    def forward(self, x):
        v = x.float().mean(dim=(1, 2)).to(x.dtype).float()
        gate = torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(v))))
        return x.float() * gate[:, None, None, :]


class OSBlock(nn.Module):
    """Omni-scale residual block: 4 streams of 1..4 LiteConvs, a shared
    aggregation gate, the identity (or its 1x1 downsample).

    ``shard`` (set by ``parallel.shard_conv_channels``): this rank holds a
    block of the output channels of the parameters and buffers named in
    ``shard.names``; both forwards run on the whole block, all-gathered
    once per change of the weights (``whole_state``)."""
    shard = None

    def __init__(self, cin, features):
        super().__init__()
        mid = max(features // 4, 4)
        self.cin, self.features = cin, features
        self.ConvBNReLU_0 = ConvBNReLU(cin, mid)
        self.AggregationGate_0 = AggregationGate(mid)
        for i in range(10):
            setattr(self, f'LiteConv_{i}', LiteConv(mid))
        self.ConvBNReLU_1 = ConvBNReLU(mid, features, relu=False)
        if cin != features:
            self.ConvBNReLU_2 = ConvBNReLU(cin, features, relu=False)

    def _cached(self, slot: str, make):
        """``make()``, kept in ``slot`` until a parameter or buffer
        changes: a new storage (``.to()``, ``load_state_dict(...,
        assign=True)``) or an in-place write (``load_state_dict``, any
        ``copy_``) moves its key."""
        tensors = [*self.parameters(), *self.buffers()]
        key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
        cache = self.__dict__.setdefault('_caches', {})
        if cache.get(slot, (None,))[0] != key:
            with torch.no_grad():
                # the keyed storages stay alive with the value, so no new
                # tensor reuses an address of the key
                cache[slot] = (key, make(), [t.detach() for t in tensors])
        return cache[slot][1]

    def whole_state(self):
        """The block's parameters and buffers by name, each whole: the
        sharded ones all-gathered over ``'model'``."""
        def make():
            sd = dict(self.named_parameters())
            sd.update(self.named_buffers())
            if self.shard is not None:
                sd = {n: self.shard.gather_rows(t) if n in self.shard.names
                      else t for n, t in sd.items()}
            return sd
        return self._cached('whole', make) if self.shard is not None \
            else make()

    def folded(self):
        """``(flat, packed)``: ``fold_osblock``'s list and, on CUDA, its
        ``pack_osblock`` buffers, made once per change of the weights."""
        def make():
            flat = fold_osblock(self.whole_state(), self.cin, self.features)
            packed = pack_osblock(flat, self.cin, self.features) \
                if flat[0].is_cuda else None
            return flat, packed
        return self._cached('fold', make)

    def forward(self, x, whole=False):
        if _PLAIN_STREAMS.get():
            if self.shard is None or whole:
                return self.plain_forward(x)
            return torch.func.functional_call(self, self.whole_state(),
                                              (x,), {'whole': True})
        flat, packed = self.folded()
        return osblock(x.to(BF16).contiguous(), flat, self.cin,
                       self.features, packed)

    def plain_forward(self, x):
        """The Flax ``OSBlock.__call__``: stream t runs LiteConvs in
        creation order (stream 1 LiteConv_0, stream 2 LiteConv_1-2, ...),
        each stream is gated, the f32 gated sum goes through conv3."""
        y = self.ConvBNReLU_0(x)
        lite = iter(range(10))
        out = None
        for t in range(1, 5):
            s = y
            for _ in range(t):
                s = getattr(self, f'LiteConv_{next(lite)}')(s)
            s = self.AggregationGate_0(s)
            out = s if out is None else out + s
        out = self.ConvBNReLU_1(out)
        identity = self.ConvBNReLU_2(x) if self.cin != self.features else x
        return torch.relu(out + identity)


class OSNet(nn.Module):
    """OSNet backbone + embedding head: conv1 7x7/2, maxpool 3x3/2, three
    2-block stages with 1x1 + avgpool transitions, conv5, global average
    pool, fc (Linear -> BN -> ReLU) to ``feature_dim``. Input NHWC
    float32 or bf16, output [B, feature_dim] float32."""
    # the stem's conv rounds its input to bf16 before anything else reads
    # it (layers.Conv.forward), so bf16 input gives float32 input's output
    # bit for bit (feature_extractor.extract_core asks for it)
    input_dtype = BF16

    def __init__(self, channels=(16, 64, 96, 128), feature_dim=512):
        super().__init__()
        c = channels
        self.ConvBNReLU_0 = ConvBNReLU(3, c[0], 7, 2)
        n_conv, n_blk, prev = 1, 0, c[0]
        self.stages = []
        for stage, ch in enumerate(c[1:]):
            names = []
            for _ in range(2):
                setattr(self, f'OSBlock_{n_blk}', OSBlock(prev, ch))
                names.append(f'OSBlock_{n_blk}')
                n_blk += 1
                prev = ch
            if stage < len(c) - 2:
                setattr(self, f'ConvBNReLU_{n_conv}', ConvBNReLU(ch, ch))
                names.append(f'ConvBNReLU_{n_conv}')
                n_conv += 1
            self.stages.append(names)
        self.conv5 = f'ConvBNReLU_{n_conv}'
        setattr(self, self.conv5, ConvBNReLU(c[-1], c[-1]))
        self.Dense_0 = nn.Linear(c[-1], feature_dim)
        self.BatchNorm_0 = BatchNorm(feature_dim)

    def forward(self, x):
        x = self.ConvBNReLU_0(x)
        # 3x3/2 max pool, 'SAME' padded with -inf (exact in f32)
        x = max_pool_same(x.float(), 3, 2).to(BF16)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
                if name.startswith('ConvBNReLU'):
                    # 2x2/2 average pool of the transition
                    x = F.avg_pool2d(x.float().permute(0, 3, 1, 2), 2, 2) \
                        .permute(0, 2, 3, 1).to(BF16)
        x = getattr(self, self.conv5)(x)
        x = x.float().mean(dim=(1, 2)).to(BF16).float()
        x = self.BatchNorm_0(self.Dense_0(x))
        return gather(self.Dense_0, torch.relu(x))


@register_reid
class OSNet025(ReIDModel):
    """OSNet x0.25: 256x128 input, 512-d, euclidean."""
    INPUT_SHAPE = (3, 256, 128)
    OUTPUT_LAYOUT = 512
    METRIC = 'euclidean'
    CHANNELS = (16, 64, 96, 128)

    @classmethod
    def build(cls):
        return OSNet(channels=cls.CHANNELS, feature_dim=cls.OUTPUT_LAYOUT)


@register_reid
class OSNet10(ReIDModel):
    """OSNet x1.0: 256x128 input, 512-d, cosine."""
    INPUT_SHAPE = (3, 256, 128)
    OUTPUT_LAYOUT = 512
    METRIC = 'cosine'
    CHANNELS = (64, 256, 384, 512)

    @classmethod
    def build(cls):
        return OSNet(channels=cls.CHANNELS, feature_dim=cls.OUTPUT_LAYOUT)
