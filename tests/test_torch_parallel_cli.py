"""The port's entry points at two ranks on the CPU (gloo on loopback):
`cli.train`, `cli.test` and `serve`, each rank a process started with
torchrun's environment (tests/test_torch_parallel.py `spawn_ranks`), at
the tiny configuration of tests/test_parallel.py (batch 8, 32x64 pairs, 3
classes, z_dim 8).

Each rank runs in a directory of its own and both are given the same
relative `--outputsroot`, so that what a rank other than 0 writes would
land in its own directory: there must be nothing. The ranks other than 0
also never see rank 0's checkpoints, so a resume can only take the
counter and the state rank 0 broadcasts.
"""
import json
import os
import signal
import sys
import time
import urllib.request

import numpy as np
import pytest

from edgegan_torch import checkpoint as ckpt
from edgegan_torch.cli import test as test_cli
from edgegan_torch.utils import metrics_io
from test_torch_parallel import _free_port, spawn_ranks, wait_ranks
from test_torch_test_cli import _pngs, _write_tree
from test_torch_variants import few_threads  # noqa: F401

SIZE = ['--num_classes', '3', '--z_dim', '8', '--output_height', '32',
        '--output_width', '64', '--input_height', '32', '--input_width',
        '64']
TRAIN = ['--batch_size', '8', '--image_dis_size', '32', '--edge_dis_size',
         '32', '--save_checkpoint_frequency', '3']


def _module(name, data, *extra, root='out'):
    return [sys.executable, '-m', name, '--device', 'cpu', '--dataroot',
            data, '--dataset', 'ds', '--outputsroot', root, '--name', 'dp',
            *SIZE, *extra]


def _run_dir(cwd):
    return os.path.join(cwd, 'out', 'dp')


def _files(root):
    """Every file under `root`, relative."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """At 2 ranks, each in its own directory: `cli.train` for 3 steps
    (cadence save at counter 2), then a relaunch that resumes and trains
    until a SIGTERM to rank 1 alone stops it (no cadence saves: counter %
    1 is never 2, quirk Q9's test)."""
    base = tmp_path_factory.mktemp('dp')
    data = str(base / 'data')
    _write_tree(data, 'train', (('0', 4), ('1', 4), ('2', 4)))
    _write_tree(data)
    cwds = [str(base / f'rank{r}') for r in range(2)]
    for c in cwds:
        os.makedirs(c)
    train = _module('edgegan_torch.cli.train', data, *TRAIN)
    first = wait_ranks(spawn_ranks(train + ['--epoch', '3'], cwds=cwds))
    log = os.path.join(_run_dir(cwds[0]), 'logs', 'metrics.jsonl')
    lines = os.path.getsize(log)
    procs = spawn_ranks(train + ['--epoch', '100',
                                 '--save_checkpoint_frequency', '1'],
                        cwds=cwds)
    deadline = time.time() + 240
    while time.time() < deadline and all(p.poll() is None for p in procs):
        with open(log) as f:
            if len(f.read()[lines:].splitlines()) >= 2:  # resumed, a step
                break
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)
    second = wait_ranks(procs)
    return dict(data=data, cwds=cwds, first=first, second=second, log=log)


def test_train_writes_on_rank_zero_and_resumes_from_its_counter(run):
    """3 steps at 2 ranks: metrics.jsonl, the event file, flags.json and
    the cadence checkpoint at counter 2 in rank 0's directory, nothing
    written in rank 1's; stdout on rank 0 only, naming the backend. The
    relaunch resumes at counter 2 on both ranks (rank 1 never sees a
    checkpoint) and logs `resumed_at` 2, then its steps from 3 on."""
    r0, r1 = (_run_dir(c) for c in run['cwds'])
    assert _files(r1) == []
    files = _files(r0)
    assert 'flags.json' in files and 'logs/metrics.jsonl' in files
    assert len([f for f in files if 'tfevents' in f]) == 2   # one a run
    assert ' [*] data parallel: 2 ranks over gloo' in run['first'][0]
    for out in (run['first'][1], run['second'][1]):
        assert 'Epoch:' not in out and 'Load' not in out
    assert ' [*] Load SUCCESS' in run['second'][0]
    with open(run['log']) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln.get('step') for ln in lines[:3]] == [2, 3, 4]
    assert lines[3] == {'resumed_at': 2}
    steps = [ln['step'] for ln in lines[4:]]
    assert steps == list(range(3, 3 + len(steps)))
    rows = metrics_io.read_metrics(run['log'])
    assert all(np.isfinite(v) for r in rows for v in r.values())


def test_sigterm_to_one_rank_stops_both_after_the_same_counter(run):
    """The SIGTERM to rank 1 alone, mid-run: its flag rides the step's
    metrics average, both ranks stop after the same step and exit 0
    within the collective timeout, and rank 0 writes one checkpoint, at
    the counter of the last logged step, beside the first run's."""
    assert ('Caught signal on a peer: saving checkpoint at counter'
            in run['second'][0])
    steps = ckpt.steps(os.path.join(_run_dir(run['cwds'][0]),
                                    'checkpoints'))
    last = metrics_io.read_metrics(run['log'])[-1]['step']
    assert steps == [2, last] and last < 100


def _reading_rank0(tmp_path, run):
    """Two rank directories whose run 'dp' reads rank 0's checkpoints."""
    checkpoints = os.path.join(_run_dir(run['cwds'][0]), 'checkpoints')
    cwds = [str(tmp_path / f'rank{r}') for r in range(2)]
    for c in cwds:
        os.makedirs(_run_dir(c))
        os.symlink(checkpoints, os.path.join(_run_dir(c), 'checkpoints'))
    return cwds


def test_cli_test_two_ranks_gives_the_one_process_tree(run, tmp_path):
    """`cli.test --test_batch_size 4` at 2 ranks (each its rows of every
    batch, the tail padded as a whole) from rank 0's checkpoint against
    one process: the same 6 files, each PNG within 1 of the one-process
    run's values (the batch statistics are summed in another order)."""
    cwds = _reading_rank0(tmp_path / 'two', run)
    one = _reading_rank0(tmp_path / 'one', run)[0]
    argv = _module('edgegan_torch.cli.test', run['data'],
                   '--test_batch_size', '4')
    test_cli.main(_module('edgegan_torch.cli.test', run['data'],
                          '--test_batch_size', '4',
                          root=os.path.join(one, 'out'))[3:])
    outs = wait_ranks(spawn_ranks(argv, cwds=cwds))
    assert ' [*] sharding inference over 2 ranks' in outs[0]
    assert 'Test:' not in outs[1]
    want = _pngs(os.path.join(_run_dir(one), 'test_output'))
    got = {}
    for c in cwds:
        got.update(_pngs(os.path.join(_run_dir(c), 'test_output')))
    assert len(want) == 6 and sorted(got) == sorted(want)
    for n, a in want.items():
        assert a.shape == got[n].shape, n
        assert np.abs(a.astype(np.int16) - got[n]).max() <= 1, n


def test_cli_test_batch_one_runs_on_rank_zero_alone(run, tmp_path):
    """Batch-1 parity mode (no --test_batch_size) at 2 ranks: rank 0 runs
    the whole test set in one process and rank 1 leaves; both exit 0."""
    cwds = _reading_rank0(tmp_path, run)
    outs = wait_ranks(spawn_ranks(
        _module('edgegan_torch.cli.test', run['data']), cwds=cwds))
    assert 'sharding' not in outs[0] and 'Test:' not in outs[1]
    assert len(_pngs(os.path.join(_run_dir(cwds[0]), 'test_output'))) == 6
    assert not os.path.exists(os.path.join(_run_dir(cwds[1]),
                                           'test_output'))


def test_serve_two_ranks_answers_and_the_follower_leaves(run, tmp_path):
    """`serve` at 2 ranks from rank 0's checkpoint: rank 0 answers a raw
    request and /healthz reports world size 2; SIGINT to rank 0 drains it,
    and rank 1 leaves when rank 0 stops: both exit 0."""
    cwds = _reading_rank0(tmp_path, run)
    port = _free_port()
    argv = [sys.executable, '-m', 'edgegan_torch.serve', '--device', 'cpu',
            '--outputsroot', 'out', '--name', 'dp', *SIZE, '--serve_batch',
            '4', '--transfer_dtype', 'float32', '--port', str(port)]
    procs = spawn_ranks(argv, cwds=cwds)
    try:
        health = None
        deadline = time.time() + 240
        while time.time() < deadline and health is None:
            assert all(p.poll() is None for p in procs)
            try:
                with urllib.request.urlopen(
                        f'http://127.0.0.1:{port}/healthz', timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.5)
        assert health['ok'] and health['world_size'] == 2
        body = np.random.RandomState(0).uniform(-1, 1, (32, 64, 3)).astype(
            '<f4').tobytes()
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate?raw=1&class_id=1', body)
        with urllib.request.urlopen(req, timeout=120) as r:
            photo = np.frombuffer(r.read(), '<f4')
        assert photo.shape == (32 * 32 * 3,) and np.isfinite(photo).all()
    finally:
        procs[0].send_signal(signal.SIGINT)
    wait_ranks(procs, timeout=120)
