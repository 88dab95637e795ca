"""Parameters of the JAX package -> state dicts of the port.

The JAX package saves a model as a flat ``.npz`` keyed by Flax paths
(``registry.save_npz``): ``params/conv3/kernel``, ``batch_stats/bn3/mean``,
``params/OSBlock_0/LiteConv_4/DepthwiseConv3x3_0/kernel``. The port's
modules carry the same names (``conv3``, ``OSBlock_0.LiteConv_4...``), so
the conversion is by name and layout only:

- a 4-d kernel is HWIO -> OIHW (a depthwise ``[3, 3, 1, C]`` becomes
  ``[C, 1, 3, 3]`` by the same permutation);
- a 2-d kernel is a Dense ``[in, out]`` -> Linear ``[out, in]``;
- BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``.

``flax_shapes`` is the inverse on shapes: a module's ``{flax/path:
shape}``, the template the checkpoint importers fill (where the JAX
importers walk a live parameter tree).
"""
from __future__ import annotations

import numpy as np
import torch

_LEAF = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
         'var': 'running_var', 'kernel': 'weight'}


def flax_to_state_dict(flat: dict) -> dict[str, torch.Tensor]:
    """Convert a flat ``{flax/path: array}`` dict to a torch state dict."""
    out = {}
    for name, arr in flat.items():
        parts = name.split('/')
        if parts[0] in ('params', 'batch_stats'):
            parts = parts[1:]
        *mods, leaf = parts
        if leaf not in _LEAF:
            raise KeyError(f'unknown parameter leaf {name!r}')
        a = np.asarray(arr, dtype=np.float32)
        if leaf == 'kernel':
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f'{name}: unexpected kernel rank {a.ndim}')
        out['.'.join(mods + [_LEAF[leaf]])] = \
            torch.from_numpy(np.array(a, copy=True))
    return out


def flax_shapes(module: torch.nn.Module) -> dict[str, tuple]:
    """``{flax/path: shape}`` of every parameter and buffer of ``module``
    (Flax layouts; a ``meta``-device module will do)."""
    out = {}
    for name, t in module.state_dict().items():
        *mods, leaf = name.split('.')
        shape = tuple(t.shape)
        if leaf in ('running_mean', 'running_var'):
            top, leaf = 'batch_stats', leaf[len('running_'):]
        elif leaf == 'weight' and t.dim() == 1:
            top, leaf = 'params', 'scale'
        elif leaf == 'weight':
            top, leaf = 'params', 'kernel'
            shape = shape[2:] + shape[1::-1] if t.dim() == 4 else shape[::-1]
        elif leaf == 'bias':
            top = 'params'
        else:
            raise KeyError(f'unknown state-dict leaf {name!r}')
        out['/'.join([top, *mods, leaf])] = shape
    return out


def load_npz(path) -> dict[str, torch.Tensor]:
    """State dict from a JAX-package ``.npz`` weight file."""
    with np.load(path) as data:
        return flax_to_state_dict({k: data[k] for k in data.files})
