"""The port's FID-vs-step sweep (`python -m edgegan_torch.cli.fid_curve`)
against the JAX package's (scripts/fid_curve.py), on the CPU.

- The same two-checkpoint ladder (counters 2 and 5, random trees of two
  seeds) is written by both packages (a port checkpoint and an Orbax
  one), and both sweeps run over one split of 16 pairs (`--limit 16`,
  `--eval_batch 4`), with the run's own classifier (the last step's; its
  point left out) and with the pinned extractor (docs/fid_extractor.npz).
  The encoder's noise of batch `idx` is JAX's (`fold_in(PRNGKey(6666),
  idx)`, read from JAX's encoder with its output layers zeroed, where z
  is the noise itself), handed to the port's `cli.evaluate.eps_for`: then
  both sweeps score the same photos. The same rows and keys; each
  point's FID within FID_RTOL (plus half the last of the 4 decimals both
  round to), l1, mse and psnr within rtol 1e-4; `fidcurve.json` with the
  same keys and values but the run's directory.
- The ladder (the extractor's point left out or kept, `--extractor_step`,
  `--max_points` subsampling, a pinned extractor) through both scripts'
  `main` on fake checkpoint directories, with the evaluation replaced by
  a stub that reports the step.
- Without matplotlib the JSON is written and one line says the plot was
  not; without a card the sweep refuses `cuda`.
"""
import contextlib
import importlib.util
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu import checkpoint as jckpt
from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.train import Networks as JNetworks
from edgegan_tpu.train.state import TrainState as JTrainState
from edgegan_torch import bridge
from edgegan_torch import checkpoint as ckpt
from edgegan_torch.cli import evaluate as evaluate_cli
from edgegan_torch.cli import fid_curve
from edgegan_torch.core.config import Config
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from test_torch_test_cli import SIZE, SIZE_FLAGS, _write_tree
from test_torch_variants import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(ROOT, 'docs', 'fid_extractor.npz')
FID_RTOL = 1e-3
FID_ROUNDING = 5e-5    # both scripts write the FID to 4 decimals
RECON_RTOL = 1e-4
LADDER = (2, 5)
SPLIT_TREE = (('0', 6), ('1', 5), ('2', 5))   # 16 pairs, 4 batches of 4
DIS = dict(image_dis_size=32, edge_dis_size=32)


def _jax_fid_curve():
    spec = importlib.util.spec_from_file_location(
        'jax_fid_curve', os.path.join(ROOT, 'scripts', 'fid_curve.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv):
    """main(argv) -> its stdout lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().strip().splitlines()


@pytest.fixture(scope='module')
def ladders(tmp_path_factory):
    """Checkpoints 2 and 5 of the same random trees as a port run ('port')
    and a JAX run ('jax'), and a split 'heldout' of 16 pairs: (data,
    outputs root)."""
    data = str(tmp_path_factory.mktemp('data'))
    _write_tree(data, phase='heldout', tree=SPLIT_TREE, seed=4)
    out = str(tmp_path_factory.mktemp('out'))
    cfg = Config(**SIZE, **DIS).derive('train')
    for seed, step in enumerate(LADDER):
        params, aux = bridge.random_jax_params(cfg, seed, critics=True)
        nets = bridge.load_jax_params(Networks(cfg, critics=True), params,
                                      aux)
        ckpt.save(os.path.join(out, 'port', 'checkpoints'), step,
                  create_train_state(nets))
        aux = {net: aux.get(net, {}) for net in params}
        jckpt.save(os.path.join(out, 'jax', 'checkpoints'), step,
                   JTrainState(step=jnp.asarray(step, jnp.int32),
                               params=params, aux=aux, opt_states={}))
    return data, out


@pytest.fixture(scope='module')
def jax_noise():
    """batch idx -> the two noise scalars JAX's evaluation draws for it:
    its encoder's z with mu and log sigma zeroed is the noise itself."""
    jcfg = JConfig(**SIZE).derive('test')
    jnets = JNetworks(jcfg)
    params, aux = bridge.random_jax_params(Config(**SIZE).derive('test'), 0)
    for head in ('FC8_mu', 'FC8_sigma'):
        params['E'][head] = jax.tree.map(np.zeros_like, params['E'][head])
    x = np.zeros((1, SIZE['output_height'], SIZE['output_width'] // 2, 3),
                 np.float32)
    encode = jax.jit(lambda key: jnets.encode(params, aux, x, key)[0][0, 0])
    cache = {}

    def eps_for(idx):
        if idx not in cache:
            keys = jax.random.split(jax.random.fold_in(
                jax.random.PRNGKey(evaluate_cli.EPS_SEED), idx))
            cache[idx] = torch.tensor([float(encode(k)) for k in keys])
        return cache[idx]
    return eps_for


def _argv(data, out, name, *extra):
    return (['--dataroot', data, '--dataset', 'ds', '--outputsroot', out,
             '--name', name, '--splits', 'heldout', '--limit', '16',
             '--eval_batch', '4'] + SIZE_FLAGS + list(extra))


@pytest.mark.parametrize('extractor', ['in-run', 'pinned'])
def test_sweep_matches_jax(ladders, jax_noise, monkeypatch, tmp_path,
                           extractor):
    data, out = ladders
    extra = ['--extractor_npz', PINNED] if extractor == 'pinned' else []
    jax_lines = _run(_jax_fid_curve().main, _argv(
        data, out, 'jax', '--outdir', str(tmp_path / 'jax'), *extra))
    monkeypatch.setattr(evaluate_cli, 'eps_for', jax_noise)
    port_lines = _run(fid_curve.main, _argv(
        data, out, 'port', '--outdir', str(tmp_path / 'port'), '--device',
        'cpu', *extra))
    steps = list(LADDER) if extractor == 'pinned' else list(LADDER[:-1])
    want = [json.loads(line) for line in jax_lines[:-1]]
    got = [json.loads(line) for line in port_lines[:-1]]
    assert [r['step'] for r in got] == [r['step'] for r in want] == steps
    for g, w in zip(got, want):
        assert list(g) == list(w) == ['step', 'heldout']
        assert list(g['heldout']) == list(w['heldout'])
        gf, wf = g['heldout']['classifier_fid'], w['heldout'][
            'classifier_fid']
        assert np.isfinite(gf) and abs(gf - wf) <= FID_RTOL * abs(wf) + \
            FID_ROUNDING, (g, w)
        for k in ('l1', 'mse', 'psnr_db'):
            np.testing.assert_allclose(g['heldout'][k], w['heldout'][k],
                                       rtol=RECON_RTOL, err_msg=k)
    with open(tmp_path / 'jax' / 'fidcurve.json') as f:
        jax_json = json.load(f)
    with open(tmp_path / 'port' / 'fidcurve.json') as f:
        port_json = json.load(f)
    assert list(port_json) == list(jax_json)
    for k in ('n_checkpoints', 'extractor_step', 'extractor_npz',
              'extractor_point_excluded', 'limit'):
        assert port_json[k] == jax_json[k], k
    assert port_json['curve'] == got
    assert (tmp_path / 'port' / 'fidcurve.png').is_file()
    assert json.loads(port_lines[-1]) == {
        'n_checkpoints': 2, 'out': str(tmp_path / 'port' / 'fidcurve.json')}


def _fake_run(root, steps):
    d = root / 'run' / 'checkpoints'
    for s in steps:
        os.makedirs(d / f'EdgeGAN-Model-{s}')
    return ['--name', 'run', '--outputsroot', str(root), '--outdir',
            str(root / 'out')]


MANY = tuple(range(2, 302, 10))           # 30 retained steps
# (retained steps, flags, the steps swept)
LADDER_CASES = {
    'in-run, own point left out': ((2, 5, 8), [], [2, 5]),
    'extractor step kept': ((2, 5, 8, 11), [
        '--extractor_step', '5', '--exclude_extractor_point', 'false'],
        [2, 5, 8, 11]),
    'max points': (MANY, ['--max_points', '5'],
                   [MANY[i] for i in (0, 7, 14, 21, 28)]),
    'pinned, every step': (MANY, ['--extractor_npz', 'x.npz',
                                  '--max_points', '0'], list(MANY)),
}


@pytest.mark.parametrize('case', list(LADDER_CASES))
def test_ladder_matches_jax(tmp_path, monkeypatch, case):
    steps, flags, swept = LADDER_CASES[case]
    argv = _fake_run(tmp_path, steps) + flags + ['--splits', 'test']
    seen = {'jax': [], 'port': []}

    def report(step):
        return {'classifier_fid': step, 'l1': 0.5, 'mse': 0.25,
                'psnr_db': 18.0}

    def jax_stub(argv):
        step = int(argv[argv.index('--step') + 1])
        seen['jax'].append(step)
        print(json.dumps(report(step)))

    def port_stub(argv, extractor):
        step = int(argv[argv.index('--step') + 1])
        seen['port'].append(step)
        return report(step), None, None

    monkeypatch.setitem(sys.modules, 'evaluate',
                        types.SimpleNamespace(main=jax_stub))
    monkeypatch.setattr(evaluate_cli, 'setup', lambda args: (None, 'cpu'))
    monkeypatch.setattr(evaluate_cli, 'make_extractor', lambda *a: None)
    monkeypatch.setattr(evaluate_cli, 'evaluate', port_stub)
    want = _run(_jax_fid_curve().main, argv)
    with open(tmp_path / 'out' / 'fidcurve.json') as f:
        jax_json = json.load(f)
    got = _run(fid_curve.main, argv)
    with open(tmp_path / 'out' / 'fidcurve.json') as f:
        port_json = json.load(f)
    assert got == want
    assert port_json == jax_json
    assert seen['port'] == seen['jax'] == swept


def test_without_matplotlib_the_json_is_written(tmp_path, monkeypatch,
                                                capsys):
    argv = _fake_run(tmp_path, (2, 5))
    monkeypatch.setattr(evaluate_cli, 'setup', lambda args: (None, 'cpu'))
    monkeypatch.setattr(evaluate_cli, 'make_extractor', lambda *a: None)
    monkeypatch.setattr(evaluate_cli, 'evaluate', lambda argv, ext: (
        {'classifier_fid': 1.0, 'l1': 0.5, 'mse': 0.25, 'psnr_db': 18.0},
        None, None))
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    summary = fid_curve.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert 'fidcurve.png was not written' in lines[-2]
    with open(tmp_path / 'out' / 'fidcurve.json') as f:
        assert json.load(f) == summary
    assert not (tmp_path / 'out' / 'fidcurve.png').exists()


def test_sweep_needs_a_card_unless_cpu(ladders, tmp_path):
    data, out = ladders
    with pytest.raises(SystemExit, match='no CUDA device'):
        fid_curve.main(_argv(data, out, 'port', '--outdir', str(tmp_path)))
    assert not (tmp_path / 'fidcurve.json').exists()
