"""Cross-loading a JAX (Orbax) training checkpoint into the port
(scripts/jax_checkpoint_to_torch.py), on the CPU.

A JAX train state is made by `edgegan_tpu.train.create_train_state` (its
networks' trees drawn by the port's `bridge.random_jax_params` at a
small size, so that no JAX program is compiled; the optimizer states are
optax's, the TrainState JAX's), each group's RMSProp mean square `nu`
set to random values (they start at ones), and saved by
`edgegan_tpu.checkpoint.save` at counters 3 and 7. Then:

- the converted entry read by the port (`checkpoint.read`) holds the JAX
  trees bit for bit: params, aux, every group's slots, step; and
  `checkpoint.load` into a train state gives back, through
  `state_trees`, the same npz contents;
- `python -m edgegan_torch.cli.train --device cpu` resumes from it at
  the JAX counter;
- the newest entry by default, another with `--step`;
- a leaf of the optimizer state outside `nu`, a missing slot and a
  misshapen slot fail loudly.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgegan_tpu import checkpoint as jckpt
from edgegan_tpu.train import create_train_state as jax_create_train_state
from edgegan_torch import bridge
from edgegan_torch import checkpoint as ckpt
from edgegan_torch.cli import train as train_cli
from edgegan_torch.core.config import Config
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from edgegan_torch.utils.metrics_io import read_metrics, read_resume_markers
from test_torch_test_cli import SIZE, SIZE_FLAGS, _write_tree
from test_torch_variants import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIS = dict(image_dis_size=32, edge_dis_size=32)
COUNTERS = (3, 7)
GROUPS = {'d': 'D', 'd_patch2': 'D_patch2', 'd_patch3': 'D_patch3',
          'd2': 'D2', 'g1': 'G1', 'g2': 'G2', 'e': 'E'}


def _script():
    spec = importlib.util.spec_from_file_location(
        'jax_checkpoint_to_torch',
        os.path.join(ROOT, 'scripts', 'jax_checkpoint_to_torch.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Trees:
    """Stands in for JAX's `Networks` in `create_train_state`: its `init`
    returns trees drawn by the port's initialiser."""

    def __init__(self, params, aux):
        self.trees = params, aux

    def init(self, rng):
        return self.trees


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A JAX run's checkpoints directory with counters 3 and 7 (different
    trees), and the state saved at 7 as numpy trees."""
    root = tmp_path_factory.mktemp('jax')
    cfg = Config(**SIZE, **DIS).derive('train')
    saved = {}
    for seed, counter in enumerate(COUNTERS):
        params, aux = bridge.random_jax_params(cfg, seed, critics=True)
        aux = {net: aux.get(net, {}) for net in params}
        state = jax_create_train_state(_Trees(params, aux),
                                       jax.random.PRNGKey(seed),
                                       cfg.learning_rate, jit_init=False)
        rng = np.random.RandomState(seed)
        state = state.replace(
            step=jnp.asarray(counter - 1, jnp.int32),
            opt_states=jax.tree.map(
                lambda x: jnp.asarray(rng.uniform(0.5, 2.0, x.shape),
                                      x.dtype), state.opt_states))
        jckpt.save(str(root / 'checkpoints'), counter, state)
        saved[counter] = jax.tree.map(np.asarray, state)
    return str(root / 'checkpoints'), saved


def _jax_flat(state):
    """The npz contents that the JAX state must become."""
    flat = bridge.flatten_npz(params=state.params, aux=state.aux)
    for group, net in GROUPS.items():
        nu = state.opt_states[group][0].nu
        flat.update(bridge.flatten_npz(**{f'opt/{group}': nu}))
    flat['step'] = np.asarray(state.step, np.int64)
    return flat


def test_converted_trees_are_the_jax_trees_bit_for_bit(jax_run, tmp_path):
    jax_dir, saved = jax_run
    out = str(tmp_path / 'port')
    assert _script().main([jax_dir, out]) == 7
    assert ckpt.steps(out) == [7]
    with np.load(os.path.join(out, 'EdgeGAN-Model-7', 'state.npz')) as data:
        stored = {k: data[k] for k in data.files}
    want = _jax_flat(saved[7])
    assert sorted(stored) == sorted(want)
    for k, v in want.items():
        assert stored[k].dtype == v.dtype and stored[k].shape == v.shape, k
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    # through the port's train state and back
    cfg = Config(**SIZE, **DIS).derive('train')
    state = create_train_state(Networks(cfg, critics=True))
    loaded, counter, state = ckpt.load(out, state)
    assert loaded and counter == 7 and state.step == 6
    back = ckpt.state_trees(state)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_train_cli_resumes_at_the_jax_counter(jax_run, tmp_path):
    jax_dir, _ = jax_run
    out = str(tmp_path / 'out')
    _script().main([jax_dir, os.path.join(out, 'vt', 'checkpoints')])
    data = str(tmp_path / 'data')
    _write_tree(data, phase='train', tree=(('0', 3), ('1', 3), ('2', 2)),
                seed=3)
    state = train_cli.main(
        ['--device', 'cpu', '--dataroot', data, '--dataset', 'ds',
         '--outputsroot', out, '--name', 'vt', '--batch_size', '4',
         '--epoch', '1', '--save_checkpoint_frequency', '1000',
         '--image_dis_size', '32', '--edge_dis_size', '32'] + SIZE_FLAGS)
    log = os.path.join(out, 'vt', 'logs', 'metrics.jsonl')
    assert read_resume_markers(log) == [7]
    rows = read_metrics(log)
    # the counter goes on from the checkpoint's, as JAX's trainer does
    assert [m['step'] for m in rows] == [8, 9]
    assert all(np.isfinite(v) for m in rows for k, v in m.items()
               if k not in ('step', 'epoch'))
    assert state.step == 8
    with open(os.path.join(out, 'vt', 'flags.json')) as f:
        assert json.load(f)['num_classes'] == SIZE['num_classes']


def test_step_picks_the_entry(jax_run, tmp_path):
    jax_dir, saved = jax_run
    script = _script()
    out = str(tmp_path / 'port')
    assert script.main([jax_dir, out, '--step', '3']) == 3
    assert ckpt.steps(out) == [3]
    assert script.main([jax_dir, out]) == 7
    assert ckpt.steps(out) == [3, 7]
    for counter in COUNTERS:
        trees, step = ckpt.read(out, counter)
        assert step == counter - 1
        np.testing.assert_array_equal(
            trees['params']['G1']['g_lin_0']['Matrix'],
            saved[counter].params['G1']['g_lin_0']['Matrix'])
    with pytest.raises(SystemExit, match='at step 4'):
        script.main([jax_dir, str(tmp_path / 'none'), '--step', '4'])


def _break(raw, how):
    d2 = raw['opt_states']['d2']
    nu = d2[0]['nu']
    if how == 'leftover':
        d2[1] = {'trace': np.zeros(3, np.float32)}
    elif how == 'missing':
        del nu['class_head']['biases']
    else:
        nu['h0']['biases'] = np.ones(5, np.float32)


@pytest.mark.parametrize('how', ['leftover', 'missing', 'misshapen'])
def test_a_leftover_or_missing_leaf_fails(jax_run, tmp_path, how):
    jax_dir, _ = jax_run
    loaded, _, raw = jckpt.load_raw(jax_dir)
    assert loaded
    script = _script()
    script.state_npz(raw)   # as restored, it converts
    _break(raw, how)
    with pytest.raises(ValueError, match='opt_states/d2'):
        script.state_npz(raw)
