"""Weights between the JAX package's trees and the port's modules.

The JAX trees are nested dicts of numpy arrays keyed by the reference's
scope names: `params` as `jax.tree.map(np.asarray, state.params)` gives
it, and `aux` holding each network's `batch_stats` collection (carried
over, though serving never reads it: quirk Q14). The port's modules use
the same names, so the map is by name; only the layouts differ:

  conv kernel     HWIO [k,k,in,out]  -> OIHW [out,in,k,k]
  deconv kernel   [k,k,out,in]       -> [in,out,k,k] (conv_transpose2d)
  dense matrix    [in,out]           -> [out,in] (F.linear)
  batch norm      `<name>_gamma` / `<name>_beta` params, and
                  `<name>_mean` / `<name>_var` in `batch_stats`

`save_npz` / `load_npz` keep the same trees as one flat npz whose keys
are '/'-joined paths (`params/G1/g_lin_0/Matrix`, ...).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .core.config import Config
from .models.layers import BatchNorm, Conv2D, Deconv2D, Linear, Mlp
from .train.networks import Networks

NETS = ('G1', 'G2', 'E')

# torch tensor = JAX array.transpose(perm), by (module type, param name)
_PERM = {(Conv2D, 'w'): (3, 2, 0, 1), (Deconv2D, 'w'): (3, 2, 0, 1),
         (Linear, 'Matrix'): (1, 0), (Mlp, 'w'): (1, 0)}


def _entries(nets: Networks) -> Iterator[Tuple[str, Tuple[str, ...],
                                               torch.Tensor, type]]:
    """(collection, JAX key path, torch tensor, owning module type) for
    every weight of G1, G2 and E."""
    for net in NETS:
        for mod_name, mod in getattr(nets, net).named_modules():
            path = tuple(mod_name.split('.')) if mod_name else ()
            if isinstance(mod, BatchNorm):
                parent, leaf = path[:-1], path[-1]
                for pname in ('gamma', 'beta'):
                    yield ('params', (net, *parent, f'{leaf}_{pname}'),
                           getattr(mod, pname), BatchNorm)
                for bname in ('mean', 'var'):
                    yield ('aux', (net, 'batch_stats', f'{leaf}_{bname}'),
                           getattr(mod, bname), BatchNorm)
                continue
            for pname, p in mod.named_parameters(recurse=False):
                yield 'params', (net, *path, pname), p, type(mod)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _inverse(perm):
    return tuple(int(i) for i in np.argsort(perm))


def load_jax_params(nets: Networks, params, aux) -> Networks:
    """Copy the JAX trees of G1, G2 and E into `nets` (in place). Other
    networks in the trees are ignored; a missing, extra or misshapen
    weight of these three raises."""
    trees = {'params': params, 'aux': aux}
    seen = set()
    with torch.no_grad():
        for coll, path, t, kind in _entries(nets):
            perm = _PERM.get((kind, path[-1]))
            try:
                arr = np.asarray(_get(trees[coll], path))
            except KeyError:
                raise KeyError(f'{coll}/{"/".join(path)} missing') from None
            if perm is not None:
                arr = arr.transpose(perm)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f'{coll}/{"/".join(path)}: shape '
                                 f'{arr.shape}, expected {tuple(t.shape)}')
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            seen.add((coll,) + path)
    for coll in ('params', 'aux'):
        for net in NETS:
            tree = trees[coll].get(net, {})
            extra = {(coll, net) + k for k in _flatten(tree)}
            extra -= seen
            if extra:
                raise ValueError(f'unused weights: {sorted(extra)[:5]}')
    return nets


def export_jax_params(nets: Networks):
    """The inverse of `load_jax_params`: (params, aux) numpy trees of G1,
    G2 and E in the JAX layouts."""
    trees = {'params': {}, 'aux': {net: {} for net in NETS}}
    for coll, path, t, kind in _entries(nets):
        arr = t.detach().float().cpu().numpy()
        perm = _PERM.get((kind, path[-1]))
        if perm is not None:
            arr = arr.transpose(_inverse(perm))
        _set(trees[coll], path, np.ascontiguousarray(arr))
    return trees['params'], trees['aux']


def save_npz(path: str, params, aux):
    flat = {'/'.join(('params',) + k): v for k, v in _flatten(params).items()}
    flat.update({'/'.join(('aux',) + k): v
                 for k, v in _flatten(aux).items()})
    np.savez(path, **flat)


def load_npz(path: str):
    """-> (params, aux) trees, as written by `save_npz`."""
    trees = {'params': {}, 'aux': {}}
    with np.load(path) as data:
        for key in data.files:
            coll, *rest = key.split('/')
            _set(trees[coll], tuple(rest), data[key])
    for net in NETS:
        trees['aux'].setdefault(net, {})
    return trees['params'], trees['aux']


def _trunc_normal(rng: np.random.Generator, shape, std: float):
    """flax's truncated_normal: a standard normal cut at +-2, scaled so
    that the cut distribution has standard deviation `std`."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2
    return out * (std / 0.87962566103423978)


def random_jax_params(config: Config, seed: int = 0, gf_dim: int = 64):
    """(params, aux) numpy trees of G1, G2 and E in the JAX layouts, drawn
    with the reference initialisers: conv kernels truncated normal 0.02,
    deconv kernels and dense matrices normal 0.02, biases and betas 0,
    gammas 1, moving mean 0 and variance 1."""
    with torch.device('meta'):
        nets = Networks(config, gf_dim=gf_dim)
    rng = np.random.default_rng(seed)
    trees = {'params': {}, 'aux': {net: {} for net in NETS}}
    for coll, path, t, kind in _entries(nets):
        shape = tuple(t.shape)
        leaf = path[-1]
        perm = _PERM.get((kind, leaf))
        if perm is not None:
            shape = tuple(shape[i] for i in _inverse(perm))
        if kind is Conv2D and leaf == 'w':
            arr = _trunc_normal(rng, shape, 0.02)
        elif perm is not None:
            arr = rng.normal(0.0, 0.02, shape)
        elif leaf.endswith('_gamma') or leaf.endswith('_var'):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        _set(trees[coll], path, arr.astype(np.float32))
    return trees['params'], trees['aux']
