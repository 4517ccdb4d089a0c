"""Data parallelism of the port (`edgegan_torch.parallel`) on the CPU: two
ranks over gloo on loopback, against one process and the JAX package, at
the tiny configuration of tests/test_parallel.py (batch 8, 32x64 pairs, 3
classes, z_dim 8).

The module fixture `ranks` spawns this file as a script once at world
size 2 and once at world size 1 (`python tests/test_torch_parallel.py
<dir>` with torchrun's environment), with a timeout, while it runs JAX.
Each case is one function that both run: the two ranks each on its rows
of the global batch, the one process on the whole batch, from the same
weights and inputs.

- One faithful step (host z, JAX's own draws), with the classifier's
  switches off and on: the ranks' averaged metrics against one process's
  within JAX's own data-parallel tolerance (rtol 2e-4, atol 1e-5,
  tests/test_parallel.py:85-88), the parameters bitwise equal across the
  ranks; and against JAX's step: the critics' losses (before any update)
  within rtol 1e-4, the rest within the step's own sensitivity
  (tests/test_torch_train.py's harness, three jittered JAX runs).
- Batch norm with statistics over both ranks: the generator's forward
  (quirk Q14's batch norm) against JAX's whole-batch forward, its
  parameter gradients against one process's, and a `D_norm='batch'`
  critic's gradient-penalty gradient (second order through the synced
  statistics) against one process's.
- Sharded inference (`infer.make_test_forward`) against JAX's
  `make_test_forward` on the whole batch, and the 2-rank `Batcher`
  against the one-process `Batcher` for the same submissions.
- The dataset's shards, and the `host_z` rows against the JAX `Dataset`'s
  at `shard=(r, 2)`; the helpers at world size 1.
"""
import contextlib
import functools
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from edgegan_torch import bridge, losses, parallel
from edgegan_torch.core.config import Config
from edgegan_torch.infer import make_test_forward
from edgegan_torch.ops import norms
from edgegan_torch.serve import Batcher
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import broadcast_state, create_train_state
from edgegan_torch.train.step import Draws, make_train_step

TINY = dict(batch_size=8, num_classes=3, z_dim=8, output_height=32,
            output_width=64, input_height=32, input_width=64,
            image_dis_size=32, edge_dis_size=32)
B, H, W = 8, 32, 64
CRITICS = ['D', 'D_patch2', 'D_patch3']
NETS = ['G1', 'G2', 'D', 'D_patch2', 'D_patch3', 'D2', 'E']
SWITCHES = ('EDGEGAN_PALLAS_PRELU', 'EDGEGAN_PALLAS_GATE')
WORKER_TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(phase='train', **kw):
    return Config(host_z=True, **{**TINY, **kw}).derive(phase)


@functools.lru_cache(maxsize=None)
def _weights(**kw):
    """The reference-initialised trees (seed 0) of every network."""
    return bridge.random_jax_params(_cfg(**kw), 0, critics=True)


def _rows(a):
    return parallel.local_rows(torch.from_numpy(np.asarray(a)))


@contextlib.contextmanager
def _switches(on):
    before = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if on:
            os.environ[k] = '1'
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---- the cases, run by the workers at 2 ranks and here at 1 ----

def step_case(inp, on):
    """One faithful step on this rank's rows: (averaged metrics, the
    parameters after the step as flat JAX-layout arrays)."""
    cfg = _cfg()
    nets = bridge.load_jax_params(Networks(cfg, critics=True), *_weights())
    state = broadcast_state(create_train_state(nets))
    draws = Draws(alpha={n: _rows(inp[f'alpha_{n}']) for n in CRITICS},
                  eps=torch.tensor(float(inp['eps'])))
    with _switches(on):
        _, m = make_train_step(nets, cfg)(state, _rows(inp['images']),
                                          _rows(inp['z']), draws)
    names = sorted(m)
    packed = torch.stack([m[k] for k in names])
    parallel.all_reduce_mean_([packed])
    out = {f'metric/{k}': np.float64(v) for k, v in zip(names,
                                                       packed.tolist())}
    flat = bridge.flatten_npz(params=bridge.export_jax_params(nets)[0])
    out.update({f'param/{k}': v for k, v in flat.items()})
    return out


def generator_case(inp):
    """G1 forward on this rank's latents inside the synced statistics,
    and the gradients of sum(out * cot) over the whole batch."""
    nets = bridge.load_jax_params(Networks(_cfg()), *_weights())
    with parallel.synced_batch_stats():
        out = nets.G1(_rows(inp['z_in']))
        loss = (out * _rows(inp['cot'])).sum()
        names, params = zip(*nets.G1.named_parameters())
        grads = list(torch.autograd.grad(loss, params))
    parallel.all_reduce_sum_(grads)
    return {'out': out.detach().permute(0, 2, 3, 1).numpy(),
            **{f'grad/{n}': g.numpy() for n, g in zip(names, grads)}}


def penalty_case(inp):
    """The joint critic with batch norm in its blocks: its gradient
    penalty on this rank's rows (a local mean, averaged over the ranks),
    and the penalty's parameter gradients (second order)."""
    cfg = _cfg(D_norm='batch')
    nets = bridge.load_jax_params(Networks(cfg, critics=True),
                                  *_weights(D_norm='batch'))
    fake = _rows(inp['fake']).permute(0, 3, 1, 2)
    real = _rows(inp['images']).permute(0, 3, 1, 2)
    with parallel.synced_batch_stats():
        gp = losses.gradient_penalty(nets.D, fake, real,
                                     _rows(inp['alpha_D']), cfg.lambda_gp)
        names, params = zip(*nets.D.named_parameters())
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(gp, params, allow_unused=True))]
    value = gp.detach().reshape(1)
    parallel.all_reduce_mean_(grads + [value])
    return {'value': value.numpy(),
            **{f'grad/{n}': g.numpy() for n, g in zip(names, grads)}}


def inference_case(inp):
    """The test forward on this rank's rows of the batch."""
    cfg = _cfg('test')
    nets = bridge.load_jax_params(Networks(cfg), *_weights())
    forward = make_test_forward(nets, cfg)
    with torch.inference_mode(), parallel.synced_batch_stats():
        edge, image = forward(_rows(inp['images']),
                              _rows(inp['classes']),
                              torch.from_numpy(inp['test_eps']))
    return {'edge': edge.numpy(), 'image': image.numpy()}


def batcher_case(inp):
    """Six requests through a Batcher at max_batch 4 (two batches): rank 0
    submits them at once and collects the photos, the others follow."""
    cfg = _cfg('test')
    nets = bridge.load_jax_params(Networks(cfg), *_weights())
    batcher = Batcher(nets, cfg, max_batch=4, max_wait_ms=50.0,
                      device='cpu', transfer_dtype='float32')
    if not parallel.is_process_zero():
        batcher.follow()
        return {}
    try:
        outs = batcher.submit_many(list(zip(inp['requests'],
                                            [0, 1, 2, 2, 1, 0])))
        photos = [q.get(timeout=WORKER_TIMEOUT_S) for q in outs]
    finally:
        batcher.stop()
    for p in photos:
        if isinstance(p, Exception):
            raise p
    return {'photos': np.stack(photos), 'world': batcher.stats()[
        'world_size']}


def run_cases(inp):
    out = {}
    for name, fn in (('step_off', lambda: step_case(inp, False)),
                     ('step_on', lambda: step_case(inp, True)),
                     ('gen', lambda: generator_case(inp)),
                     ('penalty', lambda: penalty_case(inp)),
                     ('infer', lambda: inference_case(inp)),
                     ('batcher', lambda: batcher_case(inp))):
        out.update({f'{name}/{k}': v for k, v in fn().items()})
    return out


def _worker(directory):
    torch.set_num_threads(1)
    parallel.init('cpu')
    try:
        with np.load(os.path.join(directory, 'inputs.npz')) as f:
            inp = {k: f[k] for k in f.files}
        out = run_cases(inp)
        np.savez(os.path.join(directory, f'rank{parallel.rank()}.npz'),
                 **out)
    finally:
        parallel.shutdown()


# ---- the fixture: JAX's draws and runs, the workers, one process ----

def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn_ranks(argv, world=2, cwds=None):
    """Start `argv` once per rank with torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT on loopback; none at world
    size 1), one torch thread each and a 120 s collective timeout; rank r
    in `cwds[r]` if given."""
    port = _free_port()
    procs = []
    for r in range(world):
        dist_env = {'RANK': str(r), 'WORLD_SIZE': str(world),
                    'LOCAL_RANK': str(r), 'LOCAL_WORLD_SIZE': str(world),
                    'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port)}
        e = {k: v for k, v in os.environ.items() if k not in dist_env}
        e.update({**(dist_env if world > 1 else {}),
                  'OMP_NUM_THREADS': '1', 'EDGEGAN_DIST_TIMEOUT': '120',
                  'PYTHONPATH': os.pathsep.join(
                      [ROOT, os.environ.get('PYTHONPATH', '')])})
        procs.append(subprocess.Popen(
            argv, env=e, cwd=cwds[r] if cwds else None,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs, timeout=WORKER_TIMEOUT_S):
    """Every rank's output; fails unless every rank exits 0 in time."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r}: {out[-4000:]}'
    return outs


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, few_threads):
    """(the workers' results by rank, this process's results, JAX's)."""
    import jax
    import jax.numpy as jnp

    from edgegan_tpu.core.config import Config as JConfig
    from edgegan_tpu.infer import make_test_forward as j_make_test_forward
    from edgegan_tpu.train import Networks as JNetworks
    from edgegan_tpu.train import make_train_step as j_make_train_step
    from test_torch_train import _jax_state, _tree_np, jax_draws, make_batch

    cfg = _cfg()
    jcfg = JConfig(host_z=True, **TINY).derive('train')
    jnets = JNetworks(jcfg)
    params0, aux0 = _weights()
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    encode = jax.jit(jnets.encode)
    draws = jax_draws(encode, params0, aux0, rng, batch=B)
    images, z = make_batch(0, batch=B)
    r = np.random.RandomState(5)
    classes = z[:, -1].astype(np.int64)
    z_in = np.concatenate([z[:, :-1], np.eye(3, dtype=np.float32)[classes]],
                          axis=1)
    # the test forward's two eps for key 7, as the JAX forward draws them
    test_key = jax.random.PRNGKey(7)
    left = jnp.asarray(images[:, :, :W // 2])
    test_eps = []
    for key in jax.random.split(test_key):
        zz, mu, ls = encode(params0, aux0, left, key)
        test_eps.append(float(np.mean((np.asarray(zz) - np.asarray(mu))
                                      / np.exp(np.asarray(ls)))))
    inp = dict(images=images, z=z, eps=np.float32(draws.eps),
               **{f'alpha_{n}': draws.alpha[n].numpy() for n in CRITICS},
               z_in=z_in, cot=r.randn(B, 3, H, W // 2).astype(np.float32),
               fake=np.tanh(r.randn(B, H, W, 3)).astype(np.float32),
               classes=classes, test_eps=np.asarray(test_eps, np.float32),
               requests=r.uniform(-1, 1, (6, H, W, 3)).astype(np.float32))
    dirs = [str(tmp_path_factory.mktemp(f'world{w}')) for w in (1, 2)]
    procs = []
    for w, d in zip((1, 2), dirs):
        np.savez(os.path.join(d, 'inputs.npz'), **inp)
        procs.append(spawn_ranks([sys.executable, os.path.abspath(__file__),
                                  d], world=w))

    # meanwhile: JAX (one step compilation)
    jstep = jax.jit(j_make_train_step(jnets, jcfg))
    state = _jax_state(jcfg, params0, aux0)

    def jax_run(jitter):
        im, zz = make_batch(0, jitter, batch=B)
        st, m = jstep(state, jnp.asarray(im), jnp.asarray(zz), rng)
        return {n: float(v) for n, v in m.items()}, _tree_np(st.params)

    ref = jax_run(None)
    jittered = [jax_run(np.random.RandomState(s)) for s in (97, 98, 99)]
    j_out = {
        'gen': np.asarray(jnets.generate(params0, aux0,
                                         jnp.asarray(z_in))[0]),
        'infer': [np.asarray(a) for a in j_make_test_forward(jnets, jcfg)(
            params0, aux0, jnp.asarray(images), jnp.asarray(classes),
            test_key)]}
    res = []
    for w, d, p in zip((1, 2), dirs, procs):
        wait_ranks(p)
        for k in range(w):
            with np.load(os.path.join(d, f'rank{k}.npz')) as f:
                res.append({n: f[n] for n in f.files})
    return dict(ranks=res[1:], one=res[0],
                jax=(params0, ref, jittered, j_out))


@pytest.fixture(scope='module')
def few_threads():
    """One intra-op thread here, one in each worker: the suite runs in
    several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the tests ----

def _case(res, case):
    prefix = case + '/'
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize('case', ['step_off', 'step_on'])
def test_two_rank_step_matches_one_process(ranks, case):
    """Metrics averaged over the ranks against the one-process step
    (rtol 2e-4, atol 1e-5); the parameters after the step bitwise equal
    on both ranks, and within the metrics' limits of one process's."""
    r0, r1 = (_case(r, case) for r in ranks['ranks'])
    one = _case(ranks['one'], case)
    metrics = [k for k in one if k.startswith('metric/')]
    assert len(metrics) == 11
    for k in metrics:
        assert math.isfinite(float(r0[k])), k
        np.testing.assert_allclose(float(r0[k]), float(one[k]), rtol=2e-4,
                                   atol=1e-5, err_msg=k)
        assert r0[k] == r1[k], k
    params = [k for k in one if k.startswith('param/')]
    assert len(params) > 100
    for k in params:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)


def test_two_rank_step_matches_jax(ranks):
    """The 2-rank step against JAX's one-process step from the same
    weights, batch and draws: the critics' losses (each before its
    group's update) within rtol 1e-4; every metric and every network's
    update within the step's own sensitivity (tests/test_torch_train.py:
    SENSITIVITY_X times the largest distance of a jittered JAX run from
    JAX's, plus a floor)."""
    from test_torch_train import (METRIC_FLOOR, PARAM_FLOOR, SENSITIVITY_X,
                                  _flat)

    params0, (jm, jp), jittered, _ = ranks['jax']
    got = _case(ranks['ranks'][0], 'step_off')
    pm = {k[len('metric/'):]: float(v) for k, v in got.items()
          if k.startswith('metric/')}
    pp = bridge.unflatten_npz({k[len('param/'):]: v for k, v in got.items()
                               if k.startswith('param/')})['params']
    assert set(pm) == set(jm)
    for n in ('joint_dis_dloss', 'image_dis_dloss', 'edge_dis_dloss'):
        np.testing.assert_allclose(pm[n], jm[n], rtol=1e-4, err_msg=n)
    bad = []
    for n in jm:
        d = abs(pm[n] - jm[n])
        own = max(abs(run[0][n] - jm[n]) for run in jittered)
        if d > SENSITIVITY_X * own + METRIC_FLOOR * max(1.0, abs(jm[n])):
            bad.append(f'{n}: port {d:.3g}, jittered JAX {own:.3g}')
    for net in NETS:
        start = _flat(params0[net])
        dj = _flat(jp[net]) - start
        d = np.linalg.norm(_flat(pp[net]) - start - dj)
        own = max(np.linalg.norm(_flat(run[1][net]) - start - dj)
                  for run in jittered)
        if d > SENSITIVITY_X * own + PARAM_FLOOR * np.linalg.norm(dj):
            bad.append(f'{net} update: port {d:.3g}, jittered JAX {own:.3g}')
    assert not bad, bad


def _assert_grads_close(got, ref, keys, rel):
    """The gradients `keys` within `rel` relative L2 distance, and every
    entry within `rel` of the largest entry."""
    a = np.concatenate([ref[k].ravel() for k in keys])
    b = np.concatenate([got[k].ravel() for k in keys])
    assert np.linalg.norm(a - b) <= rel * np.linalg.norm(a), (
        np.linalg.norm(a - b) / np.linalg.norm(a))
    assert np.abs(a - b).max() <= rel * np.abs(a).max(), (
        np.abs(a - b).max() / np.abs(a).max())


def test_synced_generator_forward_matches_jax(ranks):
    """G1's output over two ranks (each its rows, the batch norm's
    statistics over both) joined, against JAX's forward of the whole
    batch (the forward limit of tests/test_torch_models.py, 2e-4), and
    against one process's within 1e-5."""
    outs = [_case(r, 'gen')['out'] for r in ranks['ranks']]
    joined = np.concatenate(outs)
    assert joined.shape == (B, H, W // 2, 3)
    np.testing.assert_allclose(joined, ranks['jax'][3]['gen'], atol=2e-4)
    np.testing.assert_allclose(joined, _case(ranks['one'], 'gen')['out'],
                               atol=1e-5)


def test_synced_batch_norm_gradients_match_one_process(ranks):
    """G1's parameter gradients of one loss over the whole batch: the sum
    of the two ranks' against one process's within 1e-5 (every entry of
    the largest entry of G1's gradient, and in relative L2 distance:
    the biases in front of an instance norm have a zero gradient, which
    both give as rounding noise), and equal on both ranks."""
    r0, r1 = (_case(r, 'gen') for r in ranks['ranks'])
    one = _case(ranks['one'], 'gen')
    grads = [k for k in one if k.startswith('grad/')]
    assert any('g_norm_0' in k for k in grads)
    for k in grads:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    _assert_grads_close(r0, one, grads, 1e-5)


def test_batch_norm_critic_penalty_gradient_matches_one_process(ranks):
    """The gradient penalty of a `D_norm='batch'` critic: its input
    gradient and the penalty's parameter gradient both pass through the
    statistics over both ranks (second order). The ranks' averaged value
    and gradients against one process's, within 1e-4 (the second-order
    limit of tests/test_torch_variants.py, in its form:
    tests/test_torch_critics.py `_assert_grads_close`)."""
    r0, r1 = (_case(r, 'penalty') for r in ranks['ranks'])
    one = _case(ranks['one'], 'penalty')
    np.testing.assert_allclose(r0['value'], one['value'], rtol=1e-5)
    grads = [k for k in one if k.startswith('grad/')]
    assert any('norm' in k for k in grads)
    for k in grads:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    _assert_grads_close(r0, one, grads, 1e-4)


def test_sharded_inference_matches_jax(ranks):
    """The test forward over two ranks, joined, against JAX's
    `make_test_forward` on the whole batch with the same eps: rtol 1e-4,
    atol 1e-5 (tests/test_parallel.py:147-188)."""
    j_edge, j_image = ranks['jax'][3]['infer']
    for k, ref in (('edge', j_edge), ('image', j_image)):
        joined = np.concatenate([_case(r, 'infer')[k]
                                 for r in ranks['ranks']])
        np.testing.assert_allclose(joined, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_two_rank_batcher_matches_one_process(ranks):
    """Six submissions through the Batcher at max_batch 4 (two padded
    batches) at two ranks against one process, within 1e-5; healthz's
    world size is 2."""
    got = _case(ranks['ranks'][0], 'batcher')
    assert int(got['world']) == 2
    np.testing.assert_allclose(got['photos'],
                               _case(ranks['one'], 'batcher')['photos'],
                               atol=1e-5)


def _write_train_tree(root):
    from PIL import Image
    rng = np.random.RandomState(0)
    for c in range(3):
        d = os.path.join(root, 'ds', 'train', str(c))
        os.makedirs(d)
        for i in range(6):
            Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
                os.path.join(d, f'{c}{i}.png'))


def test_dataset_shards_join_into_one_process_batch(tmp_path):
    """Two shards of every global batch (same shuffle) join into the
    one-process batch: images and class columns equal, in order; the
    `host_z` latents of shard (r, 2) are bit-equal to the JAX Dataset's
    at shard=(r, 2) (its stream SeedSequence([seed, r, epoch, idx]))."""
    from edgegan_tpu.data import Dataset as JDataset
    from edgegan_torch.data.dataset import Dataset

    root = str(tmp_path)
    _write_train_tree(root)
    ds_cfg = dict(input_height=H, input_width=W, output_height=H,
                  output_width=W, crop=False, grayscale=False, z_dim=8)

    def port(shard):
        return Dataset(root, 'ds', float('inf'), B, ds_cfg, 3, seed=4,
                       host_z=True, shard=shard)

    one, shards = port((0, 1)), [port((r, 2)) for r in range(2)]
    jshards = [JDataset(root, 'ds', float('inf'), B, ds_cfg, 3,
                        rng=np.random.RandomState(4), shard=(r, 2), seed=4,
                        host_z=True) for r in range(2)]
    for ds in [one, *shards, *jshards]:
        ds.shuffle()
    assert len(one) == len(shards[0]) == 2
    for idx in range(len(one)):
        images, z, files = one[idx]
        parts = [ds[idx] for ds in shards]
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                      images)
        np.testing.assert_array_equal(
            np.concatenate([p[1][:, -1] for p in parts]), z[:, -1])
        assert sum([p[2] for p in parts], []) == files
        np.testing.assert_array_equal(parts[0][1], z[:B // 2])
        for p, jds in zip(parts, jshards):
            j_images, j_z, j_files = jds[idx]
            assert list(j_files) == p[2]
            np.testing.assert_array_equal(p[1], j_z)
            np.testing.assert_array_equal(p[0], j_images)


def test_helpers_are_no_ops_at_world_size_one(monkeypatch):
    """Without a launcher: no group, every helper leaves its input alone,
    the synced batch norm is the plain one bit for bit, `init` gives the
    CPU or `cuda:<gpu>`; two launched ranks with data_parallel off are
    refused."""
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    monkeypatch.delenv('LOCAL_RANK', raising=False)
    assert parallel.init('cpu') == torch.device('cpu')
    assert parallel._device('cuda', '3') == torch.device('cuda:3')
    assert not parallel.active() and parallel.world_size() == 1
    assert parallel.rank() == 0 and parallel.is_process_zero()
    x = torch.randn(6, 4, 3, 3)
    ts = [x.clone(), torch.arange(5.0)]
    parallel.all_reduce_mean_(ts)
    parallel.all_reduce_sum_(ts)
    parallel.broadcast_(ts)
    assert torch.equal(ts[0], x) and torch.equal(ts[1], torch.arange(5.0))
    assert parallel.local_rows(x) is x and parallel.sum_across(x) is x
    assert parallel.broadcast_object({'a': 1}) == {'a': 1}
    gamma, beta = torch.rand(4), torch.rand(4)
    plain = norms.batch_norm(x, gamma, beta)
    with parallel.synced_batch_stats():
        assert not parallel.batch_stats_synced()
        synced = norms.batch_norm(x, gamma, beta)
    for a, b in zip(plain, synced):
        assert torch.equal(a, b)
    parallel.barrier('alone')
    parallel.warm_collectives(torch.device('cpu'))
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(SystemExit, match='data_parallel is off'):
        parallel.init('cpu', enabled=False)


if __name__ == '__main__':
    _worker(sys.argv[1])
