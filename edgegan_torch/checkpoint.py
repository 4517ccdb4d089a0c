"""Checkpoints of the port's train state (the JAX package's checkpoint.py,
reference models/edgegan.py:635-657 semantics).

Layout: `<checkpoint_dir>/EdgeGAN-Model-<step>/state.npz`, one npz written
through the bridge's JAX-layout trees: `params/...` and `aux/...` as
`bridge.export_jax_params` gives them, `opt/<group>/...` the RMSProp
slots in the layout of the parameters they belong to, and `step`. An
entry is written to a temporary directory and renamed into place, so a
reader never sees half of one.

- Retention keeps the newest `keep` entries (tf.train.Saver's default
  of 5, reference models/edgegan.py:421); keep <= 0 keeps all.
- `load` walks the entries newest first and skips one that cannot be
  read or holds a non-finite value.
- A nan_policy=halt save goes to `EdgeGAN-Model-<step>-halt`, which
  `load`, `steps` and retention never see; only the newest is kept.

Waiting: asynchronous saves and loading a JAX (Orbax) checkpoint.
"""
from __future__ import annotations

import os
import re
import shutil
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from . import bridge
from .train.state import TrainState

MODEL_NAME = 'EdgeGAN-Model'
HALT_SUFFIX = '-halt'
STATE_FILE = 'state.npz'


def _ckpt_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir),
                        f'{MODEL_NAME}-{step}')


def steps(checkpoint_dir: str, suffix: str = ''):
    """The counters of the entries in `checkpoint_dir`, ascending (with
    `suffix`, of those entries)."""
    if not os.path.isdir(checkpoint_dir):
        return []
    pattern = rf'{MODEL_NAME}-(\d+){re.escape(suffix)}'
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(pattern, n) for n in os.listdir(checkpoint_dir))
                  if m)


def halt_steps(checkpoint_dir: str):
    """Steps of the retained halt checkpoints (the newest only)."""
    return steps(checkpoint_dir, HALT_SUFFIX)


def state_trees(state: TrainState):
    """The npz contents of `state`: flat '/'-joined keys -> numpy."""
    params, aux = bridge.export_jax_params(state.nets)
    paths = bridge.param_paths(state.nets)
    opt = {}
    for group, slots in state.slots.items():
        for qual, t in slots.items():
            path, kind = paths[qual]
            node = opt.setdefault(group, {})
            for k in path[1:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = bridge.to_jax_layout(t, kind, path[-1])
    flat = bridge.flatten_npz(params=params, aux=aux, opt=opt)
    flat['step'] = np.asarray(state.step, np.int64)
    return flat


def _write(path: str, state: TrainState):
    tmp = f'{path}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, STATE_FILE), **state_trees(state))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save(checkpoint_dir: str, step: int, state: TrainState, keep: int = 5):
    """Save `state` under the counter `step`, then apply retention."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    _write(_ckpt_path(checkpoint_dir, step), state)
    if keep > 0:
        for old in steps(checkpoint_dir)[:-keep]:
            shutil.rmtree(_ckpt_path(checkpoint_dir, old), ignore_errors=True)


def save_halt(checkpoint_dir: str, step: int, state: TrainState):
    """Save a nan_policy=halt state under `EdgeGAN-Model-<step>-halt`,
    keeping only this newest halt entry."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    _write(_ckpt_path(checkpoint_dir, step) + HALT_SUFFIX, state)
    for old in halt_steps(checkpoint_dir):
        if old != step:
            shutil.rmtree(_ckpt_path(checkpoint_dir, old) + HALT_SUFFIX,
                          ignore_errors=True)


def read(checkpoint_dir: str, step: int):
    """The stored trees of one entry: {'params', 'aux', 'opt'} and the
    step, read into host memory."""
    with np.load(os.path.join(_ckpt_path(checkpoint_dir, step),
                              STATE_FILE)) as data:
        flat = {k: data[k] for k in data.files}
    saved_step = int(flat.pop('step'))
    return bridge.unflatten_npz(flat), saved_step


def _finite(trees) -> bool:
    def walk(t):
        if isinstance(t, dict):
            return all(walk(v) for v in t.values())
        a = np.asarray(t)
        return not np.issubdtype(a.dtype, np.floating) or bool(
            np.isfinite(a).all())
    return walk(trees)


def load(checkpoint_dir: str, state: TrainState
         ) -> Tuple[bool, int, Optional[TrainState]]:
    """Restore the newest readable, finite entry into `state` (in place);
    returns (loaded, counter, state), or (False, 0, None) when there is
    none, as the reference's load() does (models/edgegan.py:641-657)."""
    for step in reversed(steps(checkpoint_dir)):
        try:
            trees, saved_step = read(checkpoint_dir, step)
        except (OSError, EOFError, KeyError, ValueError,
                zipfile.BadZipFile) as e:  # a corrupt or partial entry
            print(f' [!] checkpoint {MODEL_NAME}-{step} unreadable '
                  f'({type(e).__name__}); trying previous')
            continue
        if not _finite(trees):
            print(f' [!] checkpoint {MODEL_NAME}-{step} has non-finite '
                  'values; trying previous')
            continue
        apply(state, trees, saved_step)
        return True, step, state
    return False, 0, None


def apply(state: TrainState, trees, step: int):
    """Copy stored trees into `state`: the networks through the bridge
    (which raises on a missing, extra or misshapen weight) and every
    RMSProp slot."""
    bridge.load_jax_params(state.nets, trees['params'], trees['aux'])
    paths = bridge.param_paths(state.nets)
    with torch.no_grad():
        for group, slots in state.slots.items():
            for qual, t in slots.items():
                path, kind = paths[qual]
                node = trees['opt'][group]
                for k in path[1:]:
                    node = node[k]
                src = bridge.from_jax_layout(node, kind, path[-1])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f'opt/{group}/{qual}: shape '
                                     f'{tuple(src.shape)}, expected '
                                     f'{tuple(t.shape)}')
                t.copy_(src)
    state.step = step
