"""The ('streams', 'model') mesh over ``torch.distributed`` (port of
``fastmot_tpu/parallel/streams.py``).

  * ``streams``: data parallelism. Each block of ranks on this axis owns a
    contiguous block of the streams (``StreamTracker(..., mesh=)``,
    ``MultiStreamMOT(..., mesh=)``); the frame loop exchanges only a few
    integers across it (the flow budget, the new-track counts at ``sync``).
  * ``model``: tensor parallelism inside a detector. ``shard_conv_channels``
    keeps on each rank its slice of every conv's output channels (with
    the bias and the following batch norm's vectors) and all-gathers the
    activations along the channel axis after the last per-channel op that
    follows the conv (the conv, its BN and its activation): the gather XLA's
    SPMD partitioner inserts for the JAX package's
    ``conv_channel_shardings``.

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
    """One sharded conv of a module: the input channels its grouped conv
    reads (None: all) and the all-gather of its block's output over the
    'model' axis."""

    def __init__(self, group, k: int, in_slice: slice | None):
        self.group, self.k, self.in_slice = group, k, in_slice
        self.backend = dist.get_backend(group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., C / k]`` on each rank -> ``[..., C]`` in rank order.
        Gloo takes host tensors: bf16 travels as float32 (exact)."""
        if self.k == 1:
            return x
        send = x.contiguous()
        if self.backend == 'gloo':
            send = send.cpu()
            if send.dtype == torch.bfloat16:
                send = send.float()
        parts = [torch.empty_like(send) for _ in range(self.k)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts, -1).to(x.device, x.dtype)


def _slice_(param: torch.Tensor, sl: slice):
    param.data = param.data[sl].clone()


def shard_conv_channels(module: nn.Module, mesh: DeviceMesh,
                        axis: str = 'model') -> list[str]:
    """Keep on this rank its block of every conv's output channels that
    divide by the size k of ``axis`` (weight, bias and the following batch
    norm's four vectors), in place; the module then all-gathers each such
    conv's activations over ``axis`` after its BN and activation. A grouped
    or depthwise conv slices its input channels with its output channels.
    Returns the Flax paths sharded: ``conv_channel_plan(module, k)``.

    Every registered YOLO is a ``DarknetModule``, whose conv -> BN ->
    activation chains this walks; other modules raise ``TypeError``."""
    from ..models.darknet import DarknetModule
    if not isinstance(module, DarknetModule):
        raise TypeError(f'shard_conv_channels: {type(module).__name__} is '
                        'not a DarknetModule (the registered YOLOs)')
    k = axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    plan = conv_channel_plan(module, k)
    for name, conv in module.named_children():
        if not name.startswith('conv'):
            continue
        f = conv.weight.shape[0]
        if f % k:
            continue
        i = int(name[len('conv'):])
        out_sl = slice(r * f // k, (r + 1) * f // k)
        in_sl = None
        if conv.groups > 1:
            if conv.groups % k:
                raise ValueError(f'{name}: {conv.groups} groups do not '
                                 f'split {k} ways')
            cin = conv.weight.shape[1] * conv.groups
            in_sl = slice(r * cin // k, (r + 1) * cin // k)
            conv.groups //= k
        _slice_(conv.weight, out_sl)
        if conv.bias is not None:
            _slice_(conv.bias, out_sl)
        bn = getattr(module, f'bn{i}', None)
        if bn is not None:
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
                _slice_(t, out_sl)
        module.channel_shards[i] = ChannelShard(group, k, in_sl)
    return plan
