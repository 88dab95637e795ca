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
importers walk a live parameter tree). ``state_dict_to_flax`` is the
inverse on values, and ``save_npz`` writes the JAX package's file format
(the converter's output).
"""
from __future__ import annotations

from pathlib import Path

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


def _flax_name(name: str, dim: int) -> str:
    """The Flax path of a state-dict entry of rank ``dim``."""
    *mods, leaf = name.split('.')
    if leaf in ('running_mean', 'running_var'):
        top, leaf = 'batch_stats', leaf[len('running_'):]
    elif leaf == 'weight':
        top, leaf = 'params', 'scale' if dim == 1 else 'kernel'
    elif leaf == 'bias':
        top = 'params'
    else:
        raise KeyError(f'unknown state-dict leaf {name!r}')
    return '/'.join([top, *mods, leaf])


def _to_flax_layout(a, kernel: bool):
    """OIHW -> HWIO (a depthwise ``[C, 1, 3, 3]`` -> ``[3, 3, 1, C]``),
    Linear ``[out, in]`` -> Dense ``[in, out]``; anything else as is."""
    if kernel and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if kernel and a.ndim == 2 else a


def flax_shapes(module: torch.nn.Module) -> dict[str, tuple]:
    """``{flax/path: shape}`` of every parameter and buffer of ``module``
    (Flax layouts; a ``meta``-device module will do)."""
    out = {}
    for name, t in module.state_dict().items():
        fname = _flax_name(name, t.dim())
        shape = tuple(t.shape)
        if fname.endswith('/kernel'):
            shape = shape[2:] + shape[1::-1] if t.dim() == 4 else shape[::-1]
        out[fname] = shape
    return out


def state_dict_to_flax(state_dict) -> dict[str, np.ndarray]:
    """A torch state dict as the JAX package's flat ``{flax/path: array}``
    (the inverse of ``flax_to_state_dict``), keeping each tensor's dtype."""
    out = {}
    for name, t in state_dict.items():
        fname = _flax_name(name, t.dim())
        a = t.detach().cpu().numpy()
        out[fname] = np.ascontiguousarray(
            _to_flax_layout(a, fname.endswith('/kernel')))
    return out


def save_npz(module_or_state_dict, path):
    """Write a module (or state dict) as a JAX-package ``.npz`` weight
    file, keyed by Flax paths in Flax layouts."""
    sd = module_or_state_dict.state_dict() \
        if isinstance(module_or_state_dict, torch.nn.Module) \
        else module_or_state_dict
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **state_dict_to_flax(sd))


def load_npz(path) -> dict[str, torch.Tensor]:
    """State dict from a JAX-package ``.npz`` weight file."""
    with np.load(path) as data:
        return flax_to_state_dict({k: data[k] for k in data.files})
