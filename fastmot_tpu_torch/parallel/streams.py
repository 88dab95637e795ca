"""The ('streams', 'model') mesh over ``torch.distributed`` (port of
``fastmot_tpu/parallel/streams.py``).

  * ``streams``: data parallelism. Each block of ranks on this axis owns a
    contiguous block of the streams (``StreamTracker(..., mesh=)``,
    ``MultiStreamMOT(..., mesh=)``); the frame loop exchanges only a few
    integers across it (the flow budget, the new-track counts at ``sync``).
  * ``model``: tensor parallelism inside any network of the zoo (the
    YOLOs, the SSDs, the OSNets). ``shard_conv_channels`` keeps on each
    rank its slice of every conv, depthwise and dense layer's output
    channels (with the bias and the following batch norm's vectors) and
    all-gathers the activations along the channel axis after the last
    per-channel op of the chain (``models.layers.gather``): the gather
    XLA's SPMD partitioner inserts for the JAX package's
    ``conv_channel_shardings``. An ``OSBlock`` (the hand kernel's block)
    all-gathers its sliced weights instead and runs whole, as XLA does for
    a ``pallas_call`` with sharded operands.

The caller initialises the process group: NCCL with one rank per card for
a ``'cuda'`` mesh, gloo for a ``'cpu'`` mesh (which may also serve ranks
whose modules run on a card: its collectives move host integers only, or
stage the activations through the host).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..device import torch_device
from ..models.layers import BatchNorm, Conv, DepthwiseConv3x3
from ..weights import flax_shapes

__all__ = ['make_stream_mesh', 'shard_conv_channels', 'conv_channel_plan',
           'axis_size']

_BACKEND = {'cuda': 'nccl', 'cpu': 'gloo'}


def make_stream_mesh(devices=None, model_parallel: int = 1,
                     device: str = 'cuda') -> DeviceMesh:
    """A ``(world // model_parallel, model_parallel)`` mesh named
    ``('streams', 'model')`` over the global ranks ``devices`` (all ranks by
    default, in rank order). Needs an initialised process group: NCCL with
    one rank per card for ``device='cuda'``, gloo for ``device='cpu'``."""
    if device not in _BACKEND:
        raise ValueError(f"make_stream_mesh: device must be 'cuda' or "
                         f"'cpu', got {device!r}")
    if not dist.is_initialized():
        raise RuntimeError('make_stream_mesh: initialise the process group '
                           'first (torch.distributed.init_process_group)')
    backend = dist.get_backend()
    if backend != _BACKEND[device]:
        raise RuntimeError(f'make_stream_mesh: a {device!r} mesh needs the '
                           f'{_BACKEND[device]} backend, the process group '
                           f'uses {backend}')
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    n = len(ranks)
    assert n % model_parallel == 0, (n, model_parallel)
    if device == 'cuda':
        torch_device('cuda')
        if dist.get_world_size() > torch.cuda.device_count():
            raise RuntimeError(
                f'make_stream_mesh: NCCL takes one rank per card; '
                f'{dist.get_world_size()} ranks, '
                f'{torch.cuda.device_count()} cards')
    grid = torch.tensor(ranks, dtype=torch.int).reshape(
        n // model_parallel, model_parallel)
    return DeviceMesh(device, grid, mesh_dim_names=('streams', 'model'))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the named ``axis`` (``DeviceMesh.size`` takes its
    index)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def conv_channel_plan(module: nn.Module, k: int) -> list[str]:
    """The Flax paths ``conv_channel_shardings`` shards over a k-way axis:
    every conv or dense kernel whose output channels divide by k, and every
    per-channel vector (``bias``, ``scale``, ``mean``, ``var``) whose
    length does."""
    out = []
    for path, shape in flax_shapes(module).items():
        leaf = path.rsplit('/', 1)[-1]
        if leaf == 'kernel' and len(shape) >= 2 and shape[-1] % k == 0:
            out.append(path)
        elif leaf in ('bias', 'scale', 'mean', 'var') and len(shape) == 1 \
                and shape[0] % k == 0:
            out.append(path)
    return sorted(out)


class ChannelShard:
    """Rank ``r``'s block of ``k`` over the ``'model'`` group: of a layer's
    output channels and, for a per-channel layer, of its ``in_channels``
    input channels (``take``)."""

    def __init__(self, group, k: int, r: int, in_channels: int | None = None,
                 names=()):
        self.group, self.k, self.r = group, k, r
        self.in_channels = in_channels
        self.names = frozenset(names)      # an OSBlock's sharded leaves

    def _block(self, n: int) -> slice:
        return slice(self.r * n // self.k, (self.r + 1) * n // self.k)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's channel block of a whole input ``[..., C]``; a
        block already taken (``[..., C / k]``) passes as it is."""
        if self.in_channels is None or x.shape[-1] != self.in_channels:
            return x
        return x[..., self._block(self.in_channels)]

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Gloo takes host tensors: bf16 travels as float32 (exact)."""
        send = x.contiguous()
        if dist.get_backend(self.group) == 'gloo':
            send = send.cpu()
            if send.dtype == torch.bfloat16:
                send = send.float()
        parts = [torch.empty_like(send) for _ in range(self.k)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts, dim).to(x.device, x.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., C / k]`` on each rank -> ``[..., C]`` in rank order."""
        return self._all_gather(x, -1)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A sliced parameter ``[O / k, ...]`` -> ``[O, ...]``."""
        return self._all_gather(t, 0)


_LEAVES = (Conv, DepthwiseConv3x3, BatchNorm, nn.Linear)


def _slice_rows_(module: nn.Module, k: int, r: int) -> list[str]:
    """Keep rank r's block of dim 0 of each of ``module``'s own parameters
    and buffers that splits k ways; returns their names."""
    out = []
    for name, t in [*module.named_parameters(recurse=False),
                    *module.named_buffers(recurse=False)]:
        if t is not None and t.shape[0] % k == 0:
            n = t.shape[0]
            t.data = t.data[r * n // k:(r + 1) * n // k].clone()
            out.append(name)
    return out


def shard_conv_channels(module: nn.Module, mesh: DeviceMesh,
                        axis: str = 'model') -> list[str]:
    """Keep on this rank its block of every conv, depthwise and dense
    layer's output channels that divide by the size k of ``axis`` (weight,
    bias and the following batch norm's four vectors), in place: exactly
    the Flax paths of ``conv_channel_plan(module, k)``, which it returns.
    The module then computes each such layer's block and all-gathers it
    over ``axis`` after the chain's last per-channel op; a grouped or
    depthwise layer takes the block of its input channels. An ``OSBlock``
    keeps its slices and all-gathers them once to run whole (the kernel's
    block, as XLA gathers a ``pallas_call``'s sharded operands).

    Works on every registered model (the YOLOs' ``DarknetModule``, the
    SSDs, the OSNets): each is built from ``models.layers``' conv,
    depthwise and BN layers and ``nn.Linear``. A module holding
    parameters of another kind raises ``TypeError``."""
    from ..models.osnet import OSBlock
    k = axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    plan = conv_channel_plan(module, k)
    if k == 1:                      # one block: the whole layer
        return plan
    before = flax_shapes(module)
    blocks = [m for m in module.modules() if isinstance(m, OSBlock)]
    inside = {id(m) for b in blocks for m in b.modules()}
    for b in blocks:
        names = [f'{p}.{n}' if p else n for p, m in b.named_modules()
                 for n in _slice_rows_(m, k, r)]
        b.shard = ChannelShard(group, k, r, names=names)
    for name, m in module.named_modules():
        if id(m) in inside or next(m.parameters(recurse=False),
                                   None) is None:
            continue
        if not isinstance(m, _LEAVES):
            raise TypeError(f'shard_conv_channels: {name or "the module"} '
                            f'is a {type(m).__name__}, which holds '
                            'parameters and is not a conv, depthwise, BN '
                            'or dense layer')
        if m.weight.shape[0] % k:
            continue
        in_ch = None
        if isinstance(m, (DepthwiseConv3x3, BatchNorm)):
            in_ch = m.weight.shape[0]
        elif isinstance(m, Conv) and m.groups > 1:
            if m.groups % k:
                raise ValueError(f'{name}: {m.groups} groups do not '
                                 f'split {k} ways')
            in_ch = m.weight.shape[1] * m.groups
            m.groups //= k
        _slice_rows_(m, k, r)
        m.shard = ChannelShard(group, k, r, in_ch)
    after = flax_shapes(module)
    split = sorted(p for p, s in before.items() if after[p] != s)
    if split != plan:
        raise RuntimeError(f'shard_conv_channels: sliced {len(split)} '
                           f'leaves, the plan has {len(plan)}')
    return plan
