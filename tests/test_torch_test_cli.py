"""The port's train -> checkpoint -> test/serve path on the CPU, against
the JAX package where it has a counterpart: the test-phase dataset and
its class masking, `python -m edgegan_torch.cli.test` against
`python -m edgegan_tpu.cli.test` from the same weights, the checkpoint
functions the path adds (`load_raw`, `save_async`, `wait_for_async`,
`prune_nonfinite_checkpoints`), serving from a checkpoint directory, and
the whole path once: the training CLI with the fast step and both step
options, then the test CLI and the server from its checkpoint.

The generated panels of the two test CLIs cannot match: each draws the
encoder's noise from its own generator. So the trees are compared by
file names, PNG shapes and the input panels (byte-equal), and the port's
generated panels are held bit for bit against `infer.make_test_forward`
with the noise the CLI draws (a CPU `torch.Generator` seeded 6666, two
scalars a batch).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from edgegan_tpu import checkpoint as jckpt
from edgegan_tpu.cli import test as jtest
from edgegan_tpu.data import Dataset as JDataset
from edgegan_tpu.utils import metrics_io as jmetrics_io
from edgegan_torch import bridge
from edgegan_torch import checkpoint as ckpt
from edgegan_torch import serve
from edgegan_torch.cli import test as test_cli
from edgegan_torch.cli import train as train_cli
from edgegan_torch.core.config import Config
from edgegan_torch.data.dataset import Dataset
from edgegan_torch.infer import make_test_forward
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from edgegan_torch.utils import metrics_io
from edgegan_torch.utils.images import bytescale, inverse_transform
from test_torch_variants import few_threads  # noqa: F401

H, W = 32, 64
HALF = W // 2
SIZE = dict(num_classes=3, z_dim=8, output_height=H, output_width=W,
            input_height=H, input_width=W)
# test files: (class directory, count); '7' (>= num_classes) and 'misc'
# (not a number) are masked (quirk Q10)
TREE = (('0', 3), ('1', 2), ('2', 1), ('7', 1), ('misc', 1))
N_VALID = 6
DS_CONFIG = dict(input_height=H, input_width=W, output_height=H,
                 output_width=W, crop=False, grayscale=False)


def _write_tree(root, phase='test', tree=TREE, seed=0):
    """Random pairs with every value 0..255 present (so that an image's
    own min and max set the stretch of its saved panel)."""
    rng = np.random.RandomState(seed)
    n = 0
    for cls, count in tree:
        d = os.path.join(root, 'ds', phase, cls)
        os.makedirs(d, exist_ok=True)
        for _ in range(count):
            img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
            img[0, 0], img[0, 1] = 0, 255
            Image.fromarray(img).save(os.path.join(d, f'{n:02d}.png'))
            n += 1


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('data'))
    _write_tree(root)
    return root


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """The same G1/G2/E weights as a JAX (Orbax) checkpoint and as a port
    checkpoint, both at counter 7, under <out>/<framework>/checkpoints."""
    out = str(tmp_path_factory.mktemp('out'))
    cfg = Config(**SIZE).derive('test')
    params, aux = bridge.random_jax_params(cfg, 5)
    jckpt.save(os.path.join(out, 'jax', 'checkpoints'), 7,
               {'params': params, 'aux': aux})
    nets = bridge.load_jax_params(Networks(cfg), params, aux)
    ckpt.save(os.path.join(out, 'port', 'checkpoints'), 7,
              create_train_state(nets))
    return out, params, aux


SIZE_FLAGS = [a for k, v in SIZE.items() for a in (f'--{k}', str(v))]


def _args(data, out, name, *extra):
    return ['--dataroot', data, '--dataset', 'ds', '--outputsroot', out,
            '--name', name] + SIZE_FLAGS + list(extra)


def _share_checkpoints(out, name, root):
    """Let run `name` under `root` read the port checkpoint in `out`."""
    os.makedirs(os.path.join(root, name))
    os.symlink(os.path.join(out, 'port', 'checkpoints'),
               os.path.join(root, name, 'checkpoints'))


def _pngs(root):
    """Relative path -> pixel array of every PNG under `root`."""
    found = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            found[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return found


def _expected(data, params, aux, batch):
    """The panels the port's CLI must write ('full'): the test listing in
    batches of `batch`, the noise drawn per batch from the CLI's
    generator, the valid rows through `make_test_forward`, saved as
    `save_images` saves them."""
    cfg = Config(**SIZE).derive('test')
    nets = bridge.load_jax_params(Networks(cfg), params, aux)
    forward = make_test_forward(nets, cfg)
    ds = Dataset(data, 'ds', float('inf'), batch, DS_CONFIG, phase='test',
                 pad_tail=batch > 1)
    generator = torch.Generator().manual_seed(6666)
    out = {}
    with torch.no_grad():
        for idx in range(len(ds)):
            images, files = ds[idx]
            eps = torch.randn(2, generator=generator)
            ids, mask = test_cli.classes_padded(files, SIZE['num_classes'])
            mask &= np.array([f != Dataset.PAD for f in files])
            if not mask.any():
                continue
            edge, image = forward(torch.from_numpy(images),
                                  torch.from_numpy(ids), eps)
            panels = test_cli.compose(cfg, images, edge.numpy(),
                                      image.numpy())
            for f, ok, panel in zip(files, mask, panels):
                if ok:
                    out[os.path.join('ds', test_cli.name_with_class(f))] = \
                        bytescale(inverse_transform(panel)
                                  .astype(np.float64))
    return out


def test_test_listing_and_batches_match_jax(data):
    """The test phase lists the same files as the JAX dataset (recursive,
    sorted, every class directory) and gives the same batches, the padded
    tail included (repeats of the last file, named Dataset.PAD). The
    images agree within one float32 step at 1.0 (2^-23): for these files
    the JAX dataset decodes with its native loader, which rounds
    x / 127.5 - 1 in float32, where the port's PIL path (the JAX
    package's fallback) rounds it from float64."""
    for batch, pad in ((1, False), (3, True)):
        port = Dataset(data, 'ds', float('inf'), batch, DS_CONFIG,
                       phase='test', pad_tail=pad)
        ref = JDataset(data, 'ds', float('inf'), batch, DS_CONFIG, None,
                       'test', pad_tail=pad)
        assert port.data == ref.data and len(port) == len(ref)
        assert len(port.data) == sum(n for _, n in TREE)
        for idx in range(len(ref)):
            (pi, pf), (ri, rf) = port[idx], ref[idx]
            assert pf == rf
            np.testing.assert_allclose(pi, ri, rtol=0, atol=2.0 ** -23)
    assert pf[-1] == Dataset.PAD == JDataset.PAD
    with pytest.raises(ValueError, match='pad_tail'):
        Dataset(data, 'ds', float('inf'), 3, DS_CONFIG, pad_tail=True)


def test_class_ids_and_masks_match_jax(data):
    """`classes_of` and `classes_padded` give the JAX CLI's ids and masks:
    the class id >= num_classes and the non-numeric parent are masked,
    and a path without a parent directory is masked, not fatal."""
    files = Dataset(data, 'ds', float('inf'), 1, DS_CONFIG,
                    phase='test').data + ['bare.png', Dataset.PAD]
    n = SIZE['num_classes']
    ids, mask = test_cli.classes_of(files, n)
    rids, rmask = jtest.classes_of(files, n)
    assert ids == rids and mask.tolist() == rmask.tolist()
    assert int(mask.sum()) == N_VALID
    pids, pmask = test_cli.classes_padded(files, n)
    rpids, rpmask = jtest.classes_padded(files, n)
    np.testing.assert_array_equal(pids, rpids)
    np.testing.assert_array_equal(pmask, rpmask)
    assert [test_cli.name_with_class(f) for f in files[:N_VALID]] == [
        jtest.name_with_class(f) for f in files[:N_VALID]]


@pytest.fixture(scope='module')
def cli_trees(data, weights):
    """Both test CLIs at batch 1 from the same weights, and the port's
    batched mode (3 a batch: a padded tail) into a second run name."""
    out, _, _ = weights
    jtest.main(_args(data, out, 'jax'))
    test_cli.main(_args(data, out, 'port', '--device', 'cpu'))
    _share_checkpoints(out, 'port_batched', out)
    test_cli.main(_args(data, out, 'port_batched', '--device', 'cpu',
                        '--test_batch_size', '3'))
    return {name: _pngs(os.path.join(out, name, 'test_output'))
            for name in ('jax', 'port', 'port_batched')}


def test_cli_tree_matches_jax_cli(cli_trees, data, weights):
    """Batch 1: the same relative files as the JAX CLI (the masked rows
    left out), the same PNG shapes (the input pair then two halves,
    W + 2 * W/2 wide), byte-equal input panels, and generated panels
    bit-equal to `make_test_forward` with the CLI's noise."""
    jax_tree, port = cli_trees['jax'], cli_trees['port']
    assert sorted(port) == sorted(jax_tree) and len(port) == N_VALID
    for name, img in port.items():
        assert img.shape == jax_tree[name].shape == (H, W + 2 * HALF, 3)
        np.testing.assert_array_equal(img[:, :W], jax_tree[name][:, :W])
    _, params, aux = weights
    expected = _expected(data, params, aux, 1)
    assert sorted(expected) == sorted(port)
    for name, img in port.items():
        np.testing.assert_array_equal(img, expected[name], err_msg=name)


def test_cli_batched_mode_pads_and_writes_no_pad_row(cli_trees, data,
                                                     weights):
    """--test_batch_size 3 over 8 files (6 valid): the padded tail's row
    is computed and dropped, the files written are batch 1's, and each
    is bit-equal to `make_test_forward` on its batch with that batch's
    noise."""
    batched = cli_trees['port_batched']
    assert sorted(batched) == sorted(cli_trees['port'])
    assert not any(Dataset.PAD in name for name in batched)
    _, params, aux = weights
    expected = _expected(data, params, aux, 3)
    for name, img in batched.items():
        np.testing.assert_array_equal(img, expected[name], err_msg=name)


@pytest.mark.parametrize('combination,width', [
    ('full', W + 2 * HALF), ('inputL_outputR', 2 * HALF), ('outputR', HALF)])
def test_cli_output_combinations(tmp_path, data, weights, combination,
                                 width):
    """Each output combination the JAX CLI writes, at its width; the left
    input half is byte-equal to the JAX CLI's where it is written."""
    out, _, _ = weights
    _share_checkpoints(out, 'run', str(tmp_path))
    test_cli.main(_args(data, str(tmp_path), 'run', '--device', 'cpu',
                        '--output_combination', combination))
    got = _pngs(str(tmp_path / 'run' / 'test_output'))
    assert len(got) == N_VALID
    for img in got.values():
        assert img.shape == (H, width, 3)


def test_cli_rejects_output_l_input_r_as_jax_does(tmp_path, data):
    """'outputL_inputR' (quirk Q7) exits with the JAX CLI's message."""
    args = _args(data, str(tmp_path), 'run', '--output_combination',
                 'outputL_inputR')
    with pytest.raises(SystemExit) as port:
        test_cli.main(args + ['--device', 'cpu'])
    with pytest.raises(SystemExit) as ref:
        jtest.main(args)
    assert port.value.code == ref.value.code
    assert 'outputL_inputR' in port.value.code


def test_cli_without_checkpoint_reports_load_failed(tmp_path, data, capsys):
    test_cli.main(_args(data, str(tmp_path), 'none', '--device', 'cpu'))
    assert ' [!] Load failed...' in capsys.readouterr().out


# ---- checkpoints (tests/test_checkpoint.py:88-206, for the port) ----

def _state(seed=2):
    cfg = Config(multiclasses=False, batch_size=4, **SIZE).derive('train')
    params, aux = bridge.random_jax_params(cfg, seed, gf_dim=8,
                                           critics=True, df_dim=8)
    return create_train_state(bridge.load_jax_params(
        Networks(cfg, gf_dim=8, df_dim=8, critics=True), params, aux))


def _nan(state):
    with torch.no_grad():
        state.nets.E.FC8_mu.w.fill_(float('nan'))
    return state


def _corrupt(d, step):
    path = os.path.join(d, f'{ckpt.MODEL_NAME}-{step}', ckpt.STATE_FILE)
    with open(path, 'r+b') as f:
        f.truncate(32)


def _g1(trees):
    return trees['params']['G1']['g_lin_0']['Matrix']


def test_load_raw_newest_first_past_corrupt_and_non_finite(tmp_path,
                                                           capsys):
    """load_raw walks newest first past a truncated entry and a
    non-finite one, returning the stored trees of every network without
    a target; a pinned step is read as it is (non-finite included), and
    a step that is not there gives (False, 0, None)."""
    d = str(tmp_path)
    state = _state()
    want = bridge.export_jax_params(state.nets)[0]['G1']['g_lin_0']['Matrix']
    ckpt.save(d, 502, state)
    ckpt.save(d, 1002, state)
    ckpt.save(d, 1502, _nan(_state()))
    _corrupt(d, 1002)
    loaded, counter, trees = ckpt.load_raw(d)
    assert loaded and counter == 502
    out = capsys.readouterr().out
    assert 'non-finite' in out and 'unreadable' in out
    np.testing.assert_array_equal(_g1(trees), want)
    assert set(trees) == {'params', 'aux', 'opt'}
    assert set(trees['params']) == {'G1', 'G2', 'D', 'D_patch2', 'D_patch3',
                                    'E'}
    loaded, counter, trees = ckpt.load_raw(d, step=1502)
    assert loaded and counter == 1502
    assert not np.isfinite(trees['params']['E']['FC8_mu']['w']).all()
    assert ckpt.load_raw(d, step=999) == (False, 0, None)
    assert ckpt.load_raw(str(tmp_path / 'none')) == (False, 0, None)


def test_save_async_orders_saves_and_retains_after_the_write(tmp_path):
    """Each save_async waits for the one before; retention runs once a
    write is in place, so three saves with keep=2 leave the newest two;
    a synchronous save waits for the save in flight; the state is
    copied at the call, so a later in-place update does not reach the
    entry."""
    d = str(tmp_path)
    state = _state()
    ckpt.save_async(d, 2, state, keep=2)
    ckpt.save_async(d, 502, state, keep=2)
    with torch.no_grad():
        state.nets.G1.g_lin_0.Matrix.add_(1.0)
    ckpt.save_async(d, 1002, state, keep=2)
    ckpt.wait_for_async()
    assert ckpt.steps(d) == [502, 1002]
    first = ckpt.read(d, 502)[0]
    newest = ckpt.read(d, 1002)[0]
    np.testing.assert_array_equal(_g1(first) + 1.0, _g1(newest))
    ckpt.save_async(d, 1502, state, keep=2)
    ckpt.save(d, 2002, state, keep=2)
    assert ckpt.steps(d) == [1502, 2002]
    ckpt.wait_for_async()  # nothing in flight: returns


def test_wait_for_async_raises_what_the_write_raised(tmp_path, monkeypatch):
    """A failed background write surfaces at the next wait."""
    def fail(path, flat):
        raise OSError('disk full')
    monkeypatch.setattr(ckpt, '_write', fail)
    ckpt.save_async(str(tmp_path), 2, _state())
    with pytest.raises(OSError, match='disk full'):
        ckpt.wait_for_async()
    ckpt.wait_for_async()


def test_prune_nonfinite_checkpoints(tmp_path):
    """The non-finite tail of a ladder is deleted newest first; the newest
    finite counter and the deleted ones come back; with nothing finite
    left it exits."""
    d = str(tmp_path)
    ckpt.save(d, 502, _state())
    ckpt.save(d, 1002, _nan(_state()))
    ckpt.save(d, 1502, _nan(_state()))
    assert ckpt.prune_nonfinite_checkpoints(d) == (502, [1502, 1002])
    assert ckpt.steps(d) == [502]
    e = str(tmp_path / 'diverged')
    ckpt.save(e, 2, _nan(_state()))
    with pytest.raises(SystemExit):
        ckpt.prune_nonfinite_checkpoints(e)
    assert ckpt.steps(e) == []


def test_metrics_io_matches_jax(tmp_path):
    """read_metrics dedupes a resumed step by its last line and skips the
    markers; read_resume_markers lists them; both as the JAX package's."""
    path = str(tmp_path / 'metrics.jsonl')
    rows = [{'step': 2, 'loss': 1.0}, {'step': 3, 'loss': 2.0},
            {'resumed_at': 2}, {'step': 3, 'loss': 5.0}, {'step': 4}]
    with open(path, 'w') as f:
        f.write('\n'.join(json.dumps(r) for r in rows) + '\n\n')
    assert metrics_io.read_metrics(path) == jmetrics_io.read_metrics(path)
    assert [r['loss'] for r in metrics_io.read_metrics(path)[:2]] == [1.0,
                                                                      5.0]
    assert metrics_io.read_resume_markers(path) == \
        jmetrics_io.read_resume_markers(path) == [2]


# ---- serving from a checkpoint ----

def _serve_once(monkeypatch, argv):
    """Run serve.main with `argv`, answer one raw request through the real
    HTTP server, then shut it down; returns the photo."""
    import http.client
    got = {}
    make = serve.make_server

    def make_and_query(config, batcher, port, host):
        server = make(config, batcher, 0, host)

        def query():
            conn = http.client.HTTPConnection(*server.server_address,
                                              timeout=120)
            body = np.zeros((H, W, 3), '<f4').tobytes()
            conn.request('POST', '/generate?raw=1&class_id=1', body)
            resp = conn.getresponse()
            got['status'] = resp.status
            got['photo'] = np.frombuffer(resp.read(), '<f4')
            server.shutdown()

        threading.Thread(target=query, daemon=True).start()
        return server

    monkeypatch.setattr(serve, 'make_server', make_and_query)
    serve.main(argv)
    return got


def test_serve_main_loads_the_checkpoint_dir(monkeypatch, capsys, weights):
    """Without --weights the server restores G1/G2/E from the newest
    checkpoint under checkpoint_dir and answers; with none there it
    exits; --weights, when given, takes precedence."""
    out, params, aux = weights
    base = ['--device', 'cpu', '--transfer_dtype', 'float32',
            '--outputsroot', out] + SIZE_FLAGS
    got = _serve_once(monkeypatch, base + ['--name', 'port'])
    assert got['status'] == 200 and got['photo'].shape == (H * HALF * 3,)
    assert ' [*] serving checkpoint step 7' in capsys.readouterr().out
    with pytest.raises(SystemExit, match='no checkpoint under'):
        serve.main(base + ['--name', 'nothing'])
    npz = os.path.join(out, 'w.npz')
    bridge.save_npz(npz, params, aux)
    got = _serve_once(monkeypatch, base + ['--name', 'nothing', '--weights',
                                           npz])
    assert got['status'] == 200
    assert f' [*] serving weights {npz}' in capsys.readouterr().out


# ---- the slice as a whole ----

def test_train_test_serve_lifecycle(tmp_path, monkeypatch, capsys):
    """The training CLI with the fast step, `reference_metrics` and
    `update_sn` (2 steps, batch 4): its cadence save at counter 2 goes
    through save_async and is in place when it returns, finite, with the
    classifier's `u` advanced; the test CLI then writes every valid test
    image from it, and the server answers from it."""
    root, out = str(tmp_path / 'data'), str(tmp_path / 'out')
    _write_tree(root, 'train', (('0', 2), ('1', 1), ('2', 1)))
    _write_tree(root)
    asynchronous = []
    save_async = ckpt.save_async
    monkeypatch.setattr(ckpt, 'save_async', lambda *a, **k: (
        asynchronous.append(a[1]), save_async(*a, **k))[1])
    args = _args(root, out, 'run', '--device', 'cpu')
    train_cli.main(args + [
        '--batch_size', '4', '--image_dis_size', '32', '--edge_dis_size',
        '32', '--epoch', '2', '--save_checkpoint_frequency', '3',
        '--update_mode', 'fast', '--reference_metrics', 'True',
        '--update_sn', 'True'])
    cdir = os.path.join(out, 'run', 'checkpoints')
    assert asynchronous == [2] and ckpt.steps(cdir) == [2]
    rows = metrics_io.read_metrics(os.path.join(out, 'run', 'logs',
                                                'metrics.jsonl'))
    assert [r['step'] for r in rows] == [2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    loaded, counter, trees = ckpt.load_raw(cdir)
    assert loaded and counter == 2
    cfg = Config(batch_size=4, image_dis_size=32, edge_dis_size=32,
                 **SIZE).derive('train')
    _, aux0 = bridge.random_jax_params(cfg, cfg.seed, critics=True)
    u0 = aux0['D2']['spectral']['class_head']['u']
    u1 = trees['aux']['D2']['spectral']['class_head']['u']
    assert u1.dtype == np.float32 and np.abs(u1 - u0).max() > 1e-4
    test_cli.main(args)
    assert len(_pngs(os.path.join(out, 'run', 'test_output'))) == N_VALID
    capsys.readouterr()
    got = _serve_once(monkeypatch, ['--device', 'cpu', '--transfer_dtype',
                                    'float32', '--outputsroot', out,
                                    '--name', 'run'] + SIZE_FLAGS)
    assert got['status'] == 200
    assert ' [*] serving checkpoint step 2' in capsys.readouterr().out
