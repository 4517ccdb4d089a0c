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
- `load` (into a train state) and `load_raw` (the stored trees, for the
  test CLI and the server, which need G1, G2 and E only and so do not
  depend on the critics' sizes) walk the entries newest first and skip
  one that cannot be read or holds a non-finite value.
- `save_async` copies the state to host memory on the caller's thread
  and writes it on a background thread, one save in flight; its
  retention runs once the write is in place (`wait_for_async`, which the
  next save of any kind, and the trainer before it exits, calls).
- A nan_policy=halt save goes to `EdgeGAN-Model-<step>-halt`, which
  `load`, `steps` and retention never see; only the newest is kept.
- `prune_nonfinite_checkpoints` deletes the non-finite tail of a
  diverged run's entries.
- Data parallelism (`parallel`, two or more ranks): every rank calls the
  saves at the same counters; rank 0 alone writes, prunes and runs the
  asynchronous save, and every rank waits at a barrier until a save it
  waits for is in place (`save`, `save_halt`, `wait_for_async`). `load`
  reads on rank 0, which picks the newest finite entry and broadcasts
  its counter, so no rank can pick another while a save is in flight;
  the caller then broadcasts rank 0's state
  (`train.state.broadcast_state`).

A JAX (Orbax) checkpoint converts to this layout with
scripts/jax_checkpoint_to_torch.py (outside the package: it needs JAX);
the port then resumes from it at the JAX counter.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import re
import shutil
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from . import bridge, parallel
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


def _write(path: str, flat):
    """Write the npz contents `flat` as the entry `path`: to a temporary
    directory, flushed to disk, then renamed into place."""
    tmp = f'{path}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), 'wb') as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _retain(checkpoint_dir: str, keep: int):
    if keep > 0:
        for old in steps(checkpoint_dir)[:-keep]:
            shutil.rmtree(_ckpt_path(checkpoint_dir, old), ignore_errors=True)


def save(checkpoint_dir: str, step: int, state: TrainState, keep: int = 5):
    """Save `state` under the counter `step`, then apply retention. Waits
    for an asynchronous save in flight first."""
    wait_for_async()
    if parallel.is_process_zero():
        os.makedirs(checkpoint_dir, exist_ok=True)
        _write(_ckpt_path(checkpoint_dir, step), state_trees(state))
        _retain(checkpoint_dir, keep)
    parallel.barrier('checkpoint saved')


def save_halt(checkpoint_dir: str, step: int, state: TrainState):
    """Save a nan_policy=halt state under `EdgeGAN-Model-<step>-halt`,
    keeping only this newest halt entry."""
    wait_for_async()
    if parallel.is_process_zero():
        os.makedirs(checkpoint_dir, exist_ok=True)
        _write(_ckpt_path(checkpoint_dir, step) + HALT_SUFFIX,
               state_trees(state))
        for old in halt_steps(checkpoint_dir):
            if old != step:
                shutil.rmtree(_ckpt_path(checkpoint_dir, old) + HALT_SUFFIX,
                              ignore_errors=True)
    parallel.barrier('halt checkpoint saved')


# One writer thread, so one save in flight (made at the first submit,
# not at import); the in-flight save: (future, checkpoint_dir, keep).
_writer = cf.ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix='edgegan-checkpoint')
_inflight = None


def save_async(checkpoint_dir: str, step: int, state: TrainState,
               keep: int = 5):
    """Save `state` under the counter `step` without waiting for the
    write. Waits for the previous asynchronous save first (one in
    flight). The state is copied to host numpy here, on the caller's
    thread: each copy waits for the work queued on the parameters, and
    the train step updates them in place, so the writer must not read
    them later. Callers call `wait_for_async()` before they exit."""
    global _inflight
    wait_for_async()
    if parallel.is_process_zero():
        os.makedirs(checkpoint_dir, exist_ok=True)
        future = _writer.submit(_write, _ckpt_path(checkpoint_dir, step),
                                state_trees(state))
        _inflight = (future, checkpoint_dir, keep)


def wait_for_async(barrier: bool = True):
    """Block until the save in flight, if any, is in place, then apply its
    retention (never while its own entry is being written), and with
    `barrier` wait there for every rank. Raises what its write raised."""
    global _inflight
    pending, _inflight = _inflight, None
    if pending is not None:
        future, checkpoint_dir, keep = pending
        future.result()
        _retain(checkpoint_dir, keep)
    if barrier:
        parallel.barrier('asynchronous checkpoint in place')


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


def _newest_readable(checkpoint_dir: str):
    """(counter, trees, stored step) of the newest entry that can be read
    and holds only finite values, or None."""
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
        return step, trees, saved_step
    return None


def load(checkpoint_dir: str, state: TrainState
         ) -> Tuple[bool, int, Optional[TrainState]]:
    """Restore the newest readable, finite entry into `state` (in place);
    returns (loaded, counter, state), or (False, 0, None) when there is
    none, as the reference's load() does (models/edgegan.py:641-657).
    At two or more ranks rank 0 reads and restores, and every rank
    returns its counter; the other ranks' `state` is restored by the
    caller's `broadcast_state`."""
    found = None
    if parallel.is_process_zero():
        found = _newest_readable(checkpoint_dir)
        if found is not None:
            apply(state, found[1], found[2])
    step = parallel.broadcast_object(None if found is None else found[0])
    if step is None:
        return False, 0, None
    return True, step, state


def load_raw(checkpoint_dir: str, step: Optional[int] = None):
    """The stored trees of an entry without a target state: (loaded,
    counter, {'params', 'aux', 'opt'}) with every network's trees in the
    JAX layouts, or (False, 0, None). The newest readable, finite entry,
    or with `step` that entry as it is (the JAX package's load_raw,
    checkpoint.py:258-279)."""
    if step is not None:
        if step not in steps(checkpoint_dir):
            return False, 0, None
        return True, step, read(checkpoint_dir, step)[0]
    found = _newest_readable(checkpoint_dir)
    if found is None:
        return False, 0, None
    return True, found[0], found[1]


def prune_nonfinite_checkpoints(checkpoint_dir: str):
    """Delete, newest first, every entry whose parameters are not all
    finite, down to the newest finite one; returns (that counter, the
    deleted counters). Raises SystemExit when none survives (the JAX
    package's checkpoint.py:99-133)."""
    pruned = []
    while True:
        counters = steps(checkpoint_dir)
        if not counters:
            raise SystemExit('no finite checkpoint survived')
        step = counters[-1]
        _, _, trees = load_raw(checkpoint_dir, step)
        if _finite(trees['params']):
            return step, pruned
        pruned.append(step)
        shutil.rmtree(_ckpt_path(checkpoint_dir, step), ignore_errors=True)


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
