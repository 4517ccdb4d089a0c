"""Weights between the JAX package's trees and the port's modules.

The JAX trees are nested dicts of numpy arrays keyed by the reference's
scope names: `params` as `jax.tree.map(np.asarray, state.params)` gives
it, and `aux` holding each network's other collections: `batch_stats`
(carried over, never read: quirk Q14) and the classifier's `spectral`
vectors `u` (frozen unless the step's `update_sn`: quirk Q3). The port's
modules use the same names, so the map is by name; only the layouts
differ:

  conv kernel     HWIO [k,k,in,out]  -> OIHW [out,in,k,k]
                  (Conv2D `w`, SNConv2D `weights`)
  deconv kernel   [k,k,out,in]       -> [in,out,k,k] (conv_transpose2d)
  dense matrix    [in,out]           -> [out,in] (F.linear)
                  (Linear `Matrix`, Mlp `w`, SNDense `weights`)
  batch norm      `<block>/<name>_gamma` / `_beta` params, and
                  `batch_stats/<block>/<name>_mean` / `_var` (the block's
                  scope nested under the collection, as flax keeps it:
                  `g_norm_0_mean` at the top, `g_dconv_1/norm_mean`, ...)
  spectral norm   `aux[net]['spectral'][...path]['u']`, [1, out]
  prelu           `param`, a 0-d scalar

Only the networks a bundle holds cross the bridge: G1, G2 and E for
inference, all seven for training (`Networks(..., critics=True)`);
`load_classifier` takes one classifier's own trees (no 'D2' level), as
the pinned FID extractor stores them.
`save_npz` / `load_npz` keep the same trees as one flat npz whose keys
are '/'-joined paths (`params/G1/g_lin_0/Matrix`, ...).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .core.config import Config
from .models.classifier import Classifier
from .models.layers import (BatchNorm, Conv2D, Deconv2D, Linear, Mlp,
                            SNConv2D, SNDense)
from .train.networks import Networks

# torch tensor = JAX array.transpose(perm), by (module type, param name)
_PERM = {(Conv2D, 'w'): (3, 2, 0, 1), (Deconv2D, 'w'): (3, 2, 0, 1),
         (SNConv2D, 'weights'): (3, 2, 0, 1), (Linear, 'Matrix'): (1, 0),
         (Mlp, 'w'): (1, 0), (SNDense, 'weights'): (1, 0)}


def _networks(nets: Networks) -> Dict[str, torch.nn.Module]:
    """The networks a bundle holds, by name."""
    return {net: getattr(nets, net) for net in nets.names}


def _entries(networks: Dict[str, torch.nn.Module]
             ) -> Iterator[Tuple[str, Tuple[str, ...], torch.Tensor, type,
                             str]]:
    """(collection, JAX key path, torch tensor, owning module type, torch
    qualified name) for every weight and state vector of `networks`
    (name -> module)."""
    for net, module in networks.items():
        for mod_name, mod in module.named_modules():
            path = tuple(mod_name.split('.')) if mod_name else ()
            qual = '.'.join((net, *path))
            if isinstance(mod, BatchNorm):
                parent, leaf = path[:-1], path[-1]
                for pname in ('gamma', 'beta'):
                    yield ('params', (net, *parent, f'{leaf}_{pname}'),
                           getattr(mod, pname), BatchNorm, f'{qual}.{pname}')
                for bname in ('mean', 'var'):
                    yield ('aux', (net, 'batch_stats', *parent,
                                   f'{leaf}_{bname}'),
                           getattr(mod, bname), BatchNorm, f'{qual}.{bname}')
                continue
            for pname, p in mod.named_parameters(recurse=False):
                yield ('params', (net, *path, pname), p, type(mod),
                       f'{qual}.{pname}')
            if isinstance(mod, (SNConv2D, SNDense)):
                yield ('aux', (net, 'spectral', *path, 'u'), mod.u, type(mod),
                       f'{qual}.u')


def _contiguous(arr: np.ndarray) -> np.ndarray:
    """np.ascontiguousarray, keeping a 0-d array 0-d."""
    return np.ascontiguousarray(arr).reshape(arr.shape)


def param_paths(nets: Networks) -> Dict[str, Tuple[Tuple[str, ...], type]]:
    """torch qualified parameter name (as `nets.named_parameters()` gives
    it, e.g. 'G1.g_norm_0.gamma') -> (JAX params path, module type)."""
    return {qual: (path, kind)
            for coll, path, _, kind, qual in _entries(_networks(nets))
            if coll == 'params'}


def to_jax_layout(t: torch.Tensor, kind: type, leaf: str) -> np.ndarray:
    """A port tensor as a float32 numpy array of the JAX layout: a copy,
    which later in-place updates of the tensor leave as it is."""
    arr = t.detach().to('cpu', torch.float32, copy=True).numpy()
    perm = _PERM.get((kind, leaf))
    if perm is not None:
        arr = arr.transpose(_inverse(perm))
    return _contiguous(arr)


def from_jax_layout(arr, kind: type, leaf: str) -> torch.Tensor:
    """The inverse of `to_jax_layout`: a new CPU tensor (JAX's arrays are
    read-only)."""
    arr = np.asarray(arr)
    perm = _PERM.get((kind, leaf))
    if perm is not None:
        arr = arr.transpose(perm)
    return torch.from_numpy(np.array(arr, order='C'))


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
    """Copy the JAX trees of the networks `nets` holds into it (in
    place). Other networks in the trees are ignored; a missing, extra or
    misshapen weight of these raises."""
    _load(_networks(nets), params, aux)
    return nets


def load_classifier(classifier: Classifier, params, aux) -> Classifier:
    """Copy a classifier's own trees into it (in place): `params` and
    `aux` ({'spectral': ...}) without the 'D2' level, as the pinned FID
    extractor (docs/fid_extractor.npz) stores them. Raises as
    `load_jax_params` does."""
    _load({'D2': classifier}, {'D2': params}, {'D2': aux})
    return classifier


def _load(networks: Dict[str, torch.nn.Module], params, aux):
    trees = {'params': params, 'aux': aux}
    seen = set()
    with torch.no_grad():
        for coll, path, t, kind, _ in _entries(networks):
            try:
                arr = _get(trees[coll], path)
            except KeyError:
                raise KeyError(f'{coll}/{"/".join(path)} missing') from None
            src = from_jax_layout(arr, kind, path[-1])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f'{coll}/{"/".join(path)}: shape '
                                 f'{tuple(src.shape)}, expected '
                                 f'{tuple(t.shape)}')
            t.copy_(src)
            seen.add((coll,) + path)
    for coll in ('params', 'aux'):
        for net in networks:
            tree = trees[coll].get(net, {})
            extra = {(coll, net) + k for k in _flatten(tree)}
            extra -= seen
            if extra:
                raise ValueError(f'unused weights: {sorted(extra)[:5]}')


def export_jax_params(nets: Networks):
    """The inverse of `load_jax_params`: (params, aux) numpy trees of the
    networks `nets` holds, in the JAX layouts."""
    return _export(_networks(nets))


def export_classifier(classifier: Classifier):
    """The inverse of `load_classifier`: the classifier's own (params,
    aux) trees, without the 'D2' level."""
    params, aux = _export({'D2': classifier})
    return params['D2'], aux['D2']


def _export(networks: Dict[str, torch.nn.Module]):
    trees = {'params': {}, 'aux': {net: {} for net in networks}}
    for coll, path, t, kind, _ in _entries(networks):
        _set(trees[coll], path, to_jax_layout(t, kind, path[-1]))
    return trees['params'], trees['aux']


def flatten_npz(**trees) -> Dict[str, np.ndarray]:
    """Nested trees -> {'<tree name>/<path>': array}, the npz key scheme."""
    return {'/'.join((name,) + k): v for name, tree in trees.items()
            for k, v in _flatten(tree).items()}


def unflatten_npz(data) -> Dict[str, dict]:
    """The inverse of `flatten_npz`, from an open npz (or a dict)."""
    trees: Dict[str, dict] = {}
    for key in data.keys():
        name, *rest = key.split('/')
        _set(trees.setdefault(name, {}), tuple(rest), np.asarray(data[key]))
    return trees


def save_npz(path: str, params, aux):
    np.savez(path, **flatten_npz(params=params, aux=aux))


def load_npz(path: str):
    """-> (params, aux) trees, as written by `save_npz`."""
    with np.load(path) as data:
        trees = unflatten_npz(data)
    params, aux = trees.get('params', {}), trees.get('aux', {})
    for net in params:  # a network with no aux leaves has an empty tree
        aux.setdefault(net, {})
    return params, aux


def _trunc_normal(rng: np.random.Generator, shape, std: float):
    """flax's truncated_normal: a standard normal cut at +-2, scaled so
    that the cut distribution has standard deviation `std`."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2
    return out * (std / 0.87962566103423978)


def _xavier_uniform(rng: np.random.Generator, shape):
    """flax's glorot_uniform for a dense [in, out] matrix."""
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-limit, limit, shape)


def random_jax_params(config: Config, seed: int = 0, gf_dim: int = 64,
                      critics: bool = False, df_dim: int = 64):
    """(params, aux) numpy trees in the JAX layouts for the networks of
    `Networks(config, gf_dim, df_dim, critics=critics)`, drawn with the
    reference initialisers (the JAX package's models/layers.py:35-40):
    conv kernels truncated normal 0.02; deconv kernels, dense matrices and
    the classifier's spectral-normed convs normal 0.02; its spectral-normed
    dense layer xavier uniform; `u` truncated normal 1; PReLU leaks 0.2;
    the MRU update gates' biases 0.5 (layers.py:377-381); other biases and
    betas 0, gammas 1, moving mean 0 and variance 1."""
    with torch.device('meta'):
        nets = Networks(config, gf_dim=gf_dim, df_dim=df_dim,
                        critics=critics)
    rng = np.random.default_rng(seed)
    trees = {'params': {}, 'aux': {net: {} for net in nets.names}}
    for coll, path, t, kind, _ in _entries(_networks(nets)):
        shape = tuple(t.shape)
        leaf = path[-1]
        perm = _PERM.get((kind, leaf))
        if perm is not None:
            shape = tuple(shape[i] for i in _inverse(perm))
        if kind is Conv2D and leaf == 'w':
            arr = _trunc_normal(rng, shape, 0.02)
        elif kind is SNDense and leaf == 'weights':
            arr = _xavier_uniform(rng, shape)
        elif perm is not None:
            arr = rng.normal(0.0, 0.02, shape)
        elif leaf == 'u':
            arr = _trunc_normal(rng, shape, 1.0)
        elif leaf == 'param':
            arr = np.full(shape, 0.2)
        elif leaf == 'biases' and 'update_gate' in path:
            arr = np.full(shape, 0.5)
        elif leaf.endswith('_gamma') or leaf.endswith('_var'):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        _set(trees[coll], path, arr.astype(np.float32))
    return trees['params'], trees['aux']
