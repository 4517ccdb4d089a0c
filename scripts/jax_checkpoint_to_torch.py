"""Convert a JAX (Orbax) training checkpoint into the PyTorch port's.

    python scripts/jax_checkpoint_to_torch.py <jax checkpoint dir> \\
        <port checkpoint dir> [--step N]

Reads `<jax checkpoint dir>/EdgeGAN-Model-<step>` with
`edgegan_tpu.checkpoint.load_raw` (the newest readable, finite entry, or
the one at `--step`) and writes
`<port checkpoint dir>/EdgeGAN-Model-<step>/state.npz` in the layout of
`edgegan_torch/checkpoint.py` (`state_trees`):

- `params/<net>/...` and `aux/<net>/...`: the JAX trees as they are (the
  port's npz keeps the JAX layouts; an empty aux tree has no key);
- `opt/<group>/...`: each optimizer group's RMSProp mean-square slot
  `nu`, in the layout of the parameters it belongs to. The optax rmsprop
  state of a group is a chain (`ScaleByRmsState(nu)` and empty states),
  which Orbax restores as nested lists or dicts; it is mapped by path:
  the one `nu` subtree must hold exactly the leaves of the group's
  network's parameters, with their shapes, and every other leaf of the
  state must be empty. A leftover or missing leaf raises;
- `step`: the train state's step.

Each entry is written to a temporary directory, flushed, and renamed
into place. Then `python -m edgegan_torch.cli.train` resumes from the
port's checkpoint directory at the JAX counter, and `cli.test`, `serve`,
`cli.evaluate` and `cli.fid_curve` read it. This script needs JAX and
Orbax (it runs where the JAX package runs); the port does not.
"""
import argparse
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODEL_NAME = 'EdgeGAN-Model'
STATE_FILE = 'state.npz'
# optimizer group -> the network it updates (edgegan_tpu/train/state.py)
GROUPS = {'d': 'D', 'd_patch2': 'D_patch2', 'd_patch3': 'D_patch3',
          'd2': 'D2', 'g1': 'G1', 'g2': 'G2', 'e': 'E'}


def _items(node, path=()):
    """(path, leaf) of every leaf under a restored tree: dict keys and
    list positions, in order. None and empty containers are leaves of no
    value and are left out."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _items(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _items(v, path + (i,))
    elif node is not None:
        yield path, node


def _flat(tree, prefix):
    return {'/'.join((prefix,) + tuple(str(k) for k in path)): np.asarray(v)
            for path, v in _items(tree)}


def rmsprop_slots(group: str, state, params):
    """The `nu` leaves of one group's optax state, keyed by the parameter
    path under the network: exactly the leaves of `params` (the group's
    network's parameters), with their shapes. Raises on a leaf of the
    state outside `nu`, and on a missing, extra or misshapen slot."""
    slots, stray = {}, []
    for path, leaf in _items(state):
        if 'nu' in path:
            at = path.index('nu')
            slots[path[at + 1:]] = np.asarray(leaf)
        else:
            stray.append(path)
    if stray:
        raise ValueError(f'opt_states/{group}: leaves outside the RMSProp '
                         f'mean square nu: {stray[:5]}')
    want = {path: np.asarray(v) for path, v in _items(params)}
    missing, extra = sorted(set(want) - set(slots)), sorted(
        set(slots) - set(want))
    if missing or extra:
        raise ValueError(f'opt_states/{group}: slots missing for '
                         f'{missing[:5]}, without a parameter {extra[:5]}')
    for path, v in want.items():
        if slots[path].shape != v.shape:
            raise ValueError(f'opt_states/{group}/{"/".join(path)}: shape '
                             f'{slots[path].shape}, parameter {v.shape}')
    return slots


def state_npz(raw):
    """The port's npz contents (flat '/'-joined keys -> numpy) of a JAX
    train state as `load_raw` restores it."""
    missing = [k for k in ('params', 'aux', 'opt_states', 'step')
               if k not in raw]
    if missing:
        raise ValueError(f'not a train state: no {missing}')
    params, opt = raw['params'], raw['opt_states']
    flat = {**_flat(params, 'params'), **_flat(raw['aux'], 'aux')}
    groups = {g: n for g, n in GROUPS.items() if n in params}
    if set(opt) != set(groups):
        raise ValueError(f'optimizer groups {sorted(opt)}, expected '
                         f'{sorted(groups)} for networks {sorted(params)}')
    for group, net in groups.items():
        slots = rmsprop_slots(group, opt[group], params[net])
        for path, v in slots.items():
            flat['/'.join(('opt', group) + tuple(str(k) for k in path))] = v
    flat['step'] = np.asarray(raw['step'], np.int64)
    return flat


def write_entry(checkpoint_dir: str, step: int, flat):
    """`<checkpoint_dir>/EdgeGAN-Model-<step>/state.npz`, written to a
    temporary directory, flushed to disk, then renamed into place."""
    path = os.path.join(os.path.abspath(checkpoint_dir),
                        f'{MODEL_NAME}-{step}')
    tmp = f'{path}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), 'wb') as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser('jax_checkpoint_to_torch')
    parser.add_argument('jax_dir', help="the JAX run's checkpoints directory")
    parser.add_argument('out_dir', help="the port run's checkpoints "
                                        'directory (created)')
    parser.add_argument('--step', type=int, default=None,
                        help='convert this retained step (default: the '
                             'newest readable, finite one)')
    args = parser.parse_args(argv)

    from edgegan_tpu import checkpoint as jckpt

    loaded, counter, raw = jckpt.load_raw(args.jax_dir, step=args.step)
    if not loaded:
        raise SystemExit(f'no readable checkpoint under {args.jax_dir}'
                         + (f' at step {args.step}' if args.step is not None
                            else ''))
    path = write_entry(args.out_dir, counter, state_npz(raw))
    print(f'{MODEL_NAME}-{counter} (state step {int(raw["step"])}) -> '
          f'{path}', flush=True)
    return counter


if __name__ == '__main__':
    main()
