"""The port's fused training step and training CLI against the JAX package.

The step runs at the tiny configuration of tests/test_train_step.py with
`host_z` (the batch carries its latents), from the same weights, with the
JAX step's own random draws handed to the port: each critic's blend weight
alpha from `fold_in(rng, i)` and the encoder's scalar eps, recovered from
the JAX encoder's draw for `fold_in(rng, 3)`.

How close the two can be is set by the step itself. A WGAN-GP step
amplifies rounding: the penalty differentiates the critics' lrelu kinks and
their instance norms of 2x2 and 2x4 planes twice, and every later group
sees the earlier groups' updates. Run again with its images and latents
moved by one part in 1e6, JAX's own step moves the encoder's first update
by 9% of its size, and by the third step the edge critic's loss by 5%
and its update by 31% (measured on this configuration, these weights and
these batches). So the port is held to JAX within SENSITIVITY_X times that
sensitivity, the largest of three such jittered JAX runs made here, plus
a small floor; and tightly where no rounding reaches: the classifier sees
only the real images, and the critics' first losses come before any
update.

The bfloat16 step (`dtype='bfloat16'`, with the classifier's kernels
switched on) is held to JAX's bfloat16 step from the same weights and
draws, the blend weights drawn in bfloat16 as JAX draws them. A 1e-6
jitter vanishes in the cast to bfloat16, so JAX's bfloat16 sensitivity is
measured with the images and latents moved by about one bfloat16 rounding
(BF16_JITTER, relative), the largest of three such runs.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.train import Networks as JNetworks
from edgegan_tpu.train import make_train_step as j_make_train_step
from edgegan_tpu.train.state import TrainState as JTrainState
from edgegan_tpu.train.state import make_optimizer
from edgegan_torch import bridge
from edgegan_torch import checkpoint as ckpt
from edgegan_torch.cli import train as train_cli
from edgegan_torch.core.config import Config
from edgegan_torch.ops import kernels
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from edgegan_torch.train.step import Draws, make_train_step
from test_torch_variants import few_threads  # noqa: F401

TINY = dict(batch_size=4, num_classes=3, z_dim=8, output_height=32,
            output_width=64, input_height=32, input_width=64,
            image_dis_size=32, edge_dis_size=32)
STEPS = 3
CRITICS = ['D', 'D_patch2', 'D_patch3']   # fold_in indices 0, 1, 2
NETS = ['G1', 'G2', 'D', 'D_patch2', 'D_patch3', 'D2', 'E']
# |port - JAX| <= SENSITIVITY_X * |jittered JAX - JAX| + floor
SENSITIVITY_X = 4.0
METRIC_FLOOR = 2e-4       # relative to max(1, |metric|)
PARAM_FLOOR = 2e-3        # relative to the norm of the network's update
# bfloat16: |port - JAX| <= SENSITIVITY_BF16_X * sensitivity + floor, with
# inputs jittered by BF16_JITTER relative (bfloat16 keeps 8 bits)
BF16_JITTER = 2.0 ** -8
SENSITIVITY_BF16_X = 2.0
SWITCHES = ('EDGEGAN_PALLAS_PRELU', 'EDGEGAN_PALLAS_GATE')


def make_batch(k, jitter=None, scale=1e-6, batch=None):
    """Step k's images [B, H, W, 3] and host z [B, z_dim + 1] (latents
    and the class column), B = `batch` or TINY's; `jitter` (a
    RandomState) moves the images and latents by about `scale`
    relative."""
    b = batch or TINY['batch_size']
    images = np.random.RandomState(10 + k).randn(
        b, TINY['output_height'], TINY['output_width'], 3).clip(-1, 1)
    z = np.random.RandomState(20 + k).randn(b, TINY['z_dim'] + 1)
    z[:, -1] = np.random.RandomState(30 + k).randint(0, 3, b)
    if jitter is not None:
        images = images * (1 + scale * jitter.randn(*images.shape))
        z[:, :-1] *= 1 + scale * jitter.randn(b, TINY['z_dim'])
    return images.astype(np.float32), z.astype(np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def jax_draws(encode, params, aux, rng, dtype=jnp.float32,
              evals: bool = False, batch=None):
    """The JAX step's draws for `rng` (train/step.py:125-126): each
    critic's alpha, drawn in the step's `dtype` as losses.py:102 draws it
    (held here in float32, exactly), and the encoder's scalar eps (drawn
    in float32 in either dtype), recovered from `encode` (the JAX
    encoder) as (z - mu)/exp(log_sigma) at the entry where that is best
    conditioned. With `evals`, also the `reference_metrics` penalties'
    alphas, from `fold_in(rng, 16 + i)` (train/step.py:271-272). The
    batch has `batch` rows, or TINY's."""
    b = batch or TINY['batch_size']

    def alphas(first):
        return {name: torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(rng, first + i), (b, 1, 1, 1), dtype)).astype(
                np.float32).reshape(b))
            for i, name in enumerate(CRITICS)}

    half = jnp.zeros((b, TINY['output_height'], TINY['output_width'] // 2, 3))
    z, mu, ls = encode(params, aux, half, jax.random.fold_in(rng, 3))
    z, mu, ls = (np.asarray(a, np.float64) for a in (z, mu, ls))
    i = np.unravel_index(np.argmax(np.abs(z - mu)), z.shape)
    eps = (z[i] - mu[i]) / np.exp(ls[i])
    return Draws(alpha=alphas(0), eps=torch.tensor(eps, dtype=torch.float32),
                 alpha_eval=alphas(16) if evals else None)


@pytest.fixture(scope='module')
def runs():
    """3 steps of JAX, of JAX on jittered inputs, and of the port, all
    from the same weights (the reference initialisers, drawn by
    `bridge.random_jax_params`): per step (metrics, params) with the
    params as JAX-layout numpy trees."""
    jcfg = JConfig(host_z=True, **TINY).derive('train')
    cfg = Config(host_z=True, **TINY).derive('train')
    jnets = JNetworks(jcfg)
    params0, aux0 = bridge.random_jax_params(cfg, 0, critics=True)
    state = _jax_state(jcfg, params0, aux0)
    jstep = jax.jit(j_make_train_step(jnets, jcfg))
    encode = jax.jit(jnets.encode)
    rngs = [jax.random.fold_in(jax.random.PRNGKey(3), k)
            for k in range(STEPS)]

    def jax_run(jitter):
        st, out = state, []
        for k in range(STEPS):
            images, z = make_batch(k, jitter)
            st, m = jstep(st, jnp.asarray(images), jnp.asarray(z), rngs[k])
            out.append(({n: float(v) for n, v in m.items()},
                        _tree_np(st.params)))
        return out

    ref = jax_run(None)
    jittered = [jax_run(np.random.RandomState(seed)) for seed in (97, 98, 99)]

    nets = bridge.load_jax_params(Networks(cfg, critics=True), params0, aux0)
    tstate = create_train_state(nets)
    step = make_train_step(nets, cfg)
    port = []
    for k in range(STEPS):
        images, z = make_batch(k)
        tstate, m = step(tstate, torch.from_numpy(images),
                         torch.from_numpy(z),
                         jax_draws(encode, params0, aux0, rngs[k]))
        port.append(({n: v.item() for n, v in m.items()},
                     bridge.export_jax_params(nets)[0]))
    assert tstate.step == STEPS
    return params0, ref, jittered, port


def _jax_state(jcfg, params0, aux0):
    tx = make_optimizer(jcfg.learning_rate)
    groups = {'d': 'D', 'd_patch2': 'D_patch2', 'd_patch3': 'D_patch3',
              'd2': 'D2', 'g1': 'G1', 'g2': 'G2', 'e': 'E'}
    return JTrainState(step=jnp.asarray(0, jnp.int32), params=params0,
                       aux=aux0, opt_states={g: tx.init(params0[n])
                                             for g, n in groups.items()})


def _sensitivity_report(params0, ref, jittered, port, k):
    """Per metric and per network update at step k: (port distance, the
    largest jittered-JAX distance, scale), all from JAX's value."""
    (jm, jp), (pm, pp) = ref[k], port[k]
    metrics = {n: (abs(pm[n] - jm[n]),
                   max(abs(run[k][0][n] - jm[n]) for run in jittered),
                   max(1.0, abs(jm[n]))) for n in jm}
    nets = {}
    for net in NETS:
        start = _flat(params0[net])
        dj, dp = _flat(jp[net]) - start, _flat(pp[net]) - start
        own = max(np.linalg.norm(_flat(run[k][1][net]) - start - dj)
                  for run in jittered)
        nets[net] = (np.linalg.norm(dp - dj), own, np.linalg.norm(dj))
    return metrics, nets


def test_step_metrics_are_the_jax_step_metrics(runs):
    _, ref, _, port = runs
    assert set(port[0][0]) == set(ref[0][0]) == {
        'joint_dis_dloss', 'joint_dis_gloss', 'image_dis_dloss',
        'image_dis_gloss', 'edge_dis_dloss', 'edge_dis_gloss', 'loss_d_ac',
        'edge_gloss', 'image_gloss', 'loss_g_ac', 'zl_loss'}
    for m, _ in port:
        assert all(math.isfinite(v) for v in m.values())


def test_one_step_matches_jax(runs):
    """Step 1, where no rounding has compounded yet: the critics' and the
    classifier's losses (computed before their updates) within rtol 1e-4,
    the classifier's update within 1e-6, and everything else within the
    step's own sensitivity."""
    params0, ref, jittered, port = runs
    (jm, jp), (pm, pp) = ref[0], port[0]
    for n in ('joint_dis_dloss', 'image_dis_dloss', 'edge_dis_dloss',
              'loss_d_ac', 'loss_g_ac'):
        np.testing.assert_allclose(pm[n], jm[n], rtol=1e-4, err_msg=n)
    np.testing.assert_allclose(_flat(pp['D2']), _flat(jp['D2']), rtol=0,
                               atol=1e-6)
    _check_within_sensitivity(params0, ref, jittered, port, 0)


@pytest.mark.parametrize('k', [1, 2])
def test_trajectory_matches_jax(runs, k):
    """Steps 2 and 3 of the trajectory: the classifier, which sees only
    the real images, stays within 1e-6 of JAX and its loss within rtol
    1e-5; every metric and every network's update within the step's own
    sensitivity."""
    params0, ref, jittered, port = runs
    (jm, jp), (pm, pp) = ref[k], port[k]
    np.testing.assert_allclose(pm['loss_d_ac'], jm['loss_d_ac'], rtol=1e-5)
    np.testing.assert_allclose(_flat(pp['D2']), _flat(jp['D2']), rtol=0,
                               atol=1e-6)
    _check_within_sensitivity(params0, ref, jittered, port, k)


def _check_within_sensitivity(params0, ref, jittered, port, k):
    metrics, nets = _sensitivity_report(params0, ref, jittered, port, k)
    if os.environ.get('EDGEGAN_TEST_REPORT'):
        print(json.dumps({'step': k + 1, 'metrics': metrics, 'nets': {
            n: [float(v) for v in t] for n, t in nets.items()}}))
    bad = [f'{n}: port {d:.3g}, jittered JAX {s:.3g}'
           for n, (d, s, scale) in metrics.items()
           if d > SENSITIVITY_X * s + METRIC_FLOOR * scale]
    bad += [f'{n} update: port {d:.3g}, jittered JAX {s:.3g}, norm '
            f'{scale:.3g}' for n, (d, s, scale) in nets.items()
            if d > SENSITIVITY_X * s + PARAM_FLOOR * scale]
    assert not bad, bad


@pytest.fixture(scope='module')
def bf16_runs(runs):
    """Step 1 in bfloat16 from the float32 runs' weights and batch: JAX's,
    JAX's on inputs jittered by BF16_JITTER (three runs), and the port's
    with both classifier switches on, which also returns the calls its
    step made to the kernels' dispatch (K1, K2, K5, K3, K4), counted by
    spies; and JAX's float32 step 1 from `runs`."""
    params0, ref32 = runs[0], runs[1][0]
    jcfg = JConfig(host_z=True, dtype='bfloat16', **TINY).derive('train')
    cfg = Config(host_z=True, dtype='bfloat16', **TINY).derive('train')
    jnets = JNetworks(jcfg)
    _, aux0 = bridge.random_jax_params(cfg, 0, critics=True)
    state = _jax_state(jcfg, params0, aux0)
    jstep = jax.jit(j_make_train_step(jnets, jcfg))
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 0)

    def jax_run(jitter):
        images, z = make_batch(0, jitter, BF16_JITTER)
        st, m = jstep(state, jnp.asarray(images), jnp.asarray(z), rng)
        return {n: float(v) for n, v in m.items()}, _tree_np(st.params)

    ref = jax_run(None)
    jittered = [jax_run(np.random.RandomState(seed)) for seed in (97, 98, 99)]
    draws = jax_draws(jax.jit(jnets.encode), params0, aux0, rng,
                      jnp.bfloat16)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in SWITCHES:
            mp.setenv(name, '1')
        for name in ('_forward', 'instance_norm_act_bwd', 'prelu_bwd',
                     'mru_gate_blend', 'mru_gate_bwd'):
            fn = getattr(kernels, name)
            mp.setattr(kernels, name, lambda *a, _f=fn, _n=name:
                       calls.append(_n) or _f(*a))
        nets = bridge.load_jax_params(Networks(cfg, critics=True), params0,
                                      aux0)
        images, z = make_batch(0)
        _, m = make_train_step(nets, cfg)(
            create_train_state(nets), torch.from_numpy(images),
            torch.from_numpy(z), draws)
    port = ({n: v.item() for n, v in m.items()},
            bridge.export_jax_params(nets)[0])
    return params0, ref, jittered, port, ref32, calls


def test_bf16_step_matches_jax_bf16(bf16_runs):
    """The port's bfloat16 step, classifier kernels on, against JAX's
    bfloat16 step: every metric and every network's update within
    SENSITIVITY_BF16_X times JAX's own bfloat16 sensitivity plus the
    float32 floors; weights, slots and metrics stay float32. The
    classifier's update is also allowed JAX's own bfloat16 error, the
    distance of JAX's bfloat16 update from its float32 one: JAX on the
    CPU moves the classifier's bias updates by up to 3x their size in
    bfloat16, a change no input jitter reaches (the classifier draws no
    blend weight), while the port's stay within 4% of JAX's float32 ones
    (both measured on these weights)."""
    params0, (jm, jp), jittered, (pm, pp), (fm, fp), _ = bf16_runs
    assert set(pm) == set(jm) and all(math.isfinite(v) for v in pm.values())
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(pp))
    bad = []
    for n in jm:
        d = abs(pm[n] - jm[n])
        own = max(abs(run[0][n] - jm[n]) for run in jittered)
        if d > SENSITIVITY_BF16_X * own + METRIC_FLOOR * max(1.0, abs(jm[n])):
            bad.append(f'{n}: port {d:.3g}, jittered JAX {own:.3g}')
    for net in NETS:
        start = _flat(params0[net])
        dj = _flat(jp[net]) - start
        d = np.linalg.norm(_flat(pp[net]) - start - dj)
        own = max(np.linalg.norm(_flat(run[1][net]) - start - dj)
                  for run in jittered)
        if net == 'D2':
            own = max(own, np.linalg.norm(_flat(fp[net]) - start - dj))
        if d > SENSITIVITY_BF16_X * own + PARAM_FLOOR * np.linalg.norm(dj):
            bad.append(f'{net} update: port {d:.3g}, JAX sensitivity '
                       f'{own:.3g}')
    assert not bad, bad


def test_bf16_step_launches_every_kernel(bf16_runs):
    """One bfloat16 step with both switches on calls K5 42 times (14
    PReLUs x 3 classifier backwards), K3 and K4 12 times each (4 gates x
    3 classifier passes), and K1 and K2 21 and 12 times, as in float32."""
    calls = bf16_runs[-1]
    assert {n: calls.count(n) for n in set(calls)} == {
        '_forward': 21, 'instance_norm_act_bwd': 12, 'prelu_bwd': 42,
        'mru_gate_blend': 12, 'mru_gate_bwd': 12}


def test_launches_per_step_and_step_options(monkeypatch):
    """One step calls K1 21 times (7 generator forwards: the encoder's
    input comes from G1 alone) and K2 12 times (2 updates x 2 generators x
    3 blocks), counted by a spy on the CPU dispatch, here in the
    single-class configuration (no classifier, latents drawn for the
    step). Each of the step's options builds and runs a step alone, with
    finite metrics: `update_mode='fast'` calls K1 12 and K2 6 times (the
    critics' fakes and one generator update; the encoder takes the
    step-start fake), `reference_metrics` adds 12 calls of K1 and no K2
    (a fresh generator forward and the generators' losses, evaluated
    without a gradient), and `update_sn` leaves the launches as they are
    (here without a classifier, whose `u` it would advance)."""
    calls = []
    fwd, bwd = kernels._forward, kernels.instance_norm_act_bwd
    monkeypatch.setattr(kernels, '_forward',
                        lambda *a: calls.append('K1') or fwd(*a))
    monkeypatch.setattr(kernels, 'instance_norm_act_bwd',
                        lambda *a: calls.append('K2') or bwd(*a))
    for kw, k1, k2 in ((dict(), 21, 12), (dict(update_mode='fast'), 12, 6),
                       (dict(reference_metrics=True), 33, 12),
                       (dict(update_sn=True), 21, 12)):
        cfg = Config(multiclasses=False, **TINY, **kw).derive('train')
        params, aux = bridge.random_jax_params(cfg, 1, gf_dim=8,
                                               critics=True, df_dim=8)
        nets = bridge.load_jax_params(
            Networks(cfg, gf_dim=8, df_dim=8, critics=True), params, aux)
        assert 'D2' not in nets.names
        state = create_train_state(nets)
        images, z = make_batch(0)
        draws = cli_draws(cfg)
        assert (draws.alpha_eval is not None) == cfg.reference_metrics
        calls.clear()
        state, metrics = make_train_step(nets, cfg)(
            state, torch.from_numpy(images), torch.from_numpy(z[:, :0]),
            draws)
        assert (calls.count('K1'), calls.count('K2')) == (k1, k2), kw
        assert state.step == 1 and 'loss_d_ac' not in metrics
        assert len(metrics) == 10 and float(metrics['loss_g_ac']) == 0
        assert all(math.isfinite(float(v)) for v in metrics.values()), kw
    with pytest.raises(ValueError, match='update_mode'):
        make_train_step(nets, Config(update_mode='other', **TINY).derive(
            'train'))


def cli_draws(cfg):
    """Draws from a CPU torch.Generator, as the CLI makes them."""
    from edgegan_torch.train.step import make_draws
    return make_draws(cfg, cfg.batch_size, torch.Generator().manual_seed(0),
                      'cpu')


def _write_pngs(root, n, classes, h, w):
    from PIL import Image
    rng = np.random.RandomState(0)
    for i in range(n):
        d = os.path.join(root, 'ds', 'train', str(i % classes))
        os.makedirs(d, exist_ok=True)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(d, f'{i}.png'))


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_cli_trains_saves_and_resumes(tmp_path):
    """`python -m edgegan_torch.cli.train --device cpu` at a tiny size,
    one batch per epoch: the step to counter 2 saves (the Q9 cadence
    `counter % 3 == 2`) the state it leaves, every metric is finite, and a
    relaunch restores counter 2 (`resumed_at`), restarts its epoch loop at
    0 and takes 2 more steps without saving."""
    root, out = str(tmp_path / 'data'), str(tmp_path / 'out')
    _write_pngs(root, 4, 3, 32, 64)
    args = ['--device', 'cpu', '--dataroot', root, '--dataset', 'ds',
            '--outputsroot', out, '--name', 'cli', '--batch_size', '4',
            '--num_classes', '3', '--z_dim', '8', '--output_height', '32',
            '--output_width', '64', '--input_height', '32',
            '--input_width', '64', '--image_dis_size', '32',
            '--edge_dis_size', '32', '--save_checkpoint_frequency', '3']
    state = train_cli.main(args + ['--epoch', '1'])
    cdir = os.path.join(out, 'cli', 'checkpoints')
    log = os.path.join(out, 'cli', 'logs', 'metrics.jsonl')
    assert ckpt.steps(cdir) == [2] and state.step == 1
    first = _lines(log)
    assert [m['step'] for m in first] == [2] and len(first[0]) == 13
    assert all(math.isfinite(v) for m in first for v in m.values())
    saved, saved_step = ckpt.read(cdir, 2)
    assert saved_step == 1
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(saved['params']),
        jax.tree.leaves(bridge.export_jax_params(state.nets)[0])))

    state = train_cli.main(args + ['--epoch', '2'])
    lines = _lines(log)[len(first):]
    assert lines[0] == {'resumed_at': 2}
    assert [(m['step'], m['epoch']) for m in lines[1:]] == [(3, 0), (4, 1)]
    assert state.step == 3 and ckpt.steps(cdir) == [2]
    with open(os.path.join(out, 'cli', 'flags.json')) as f:
        assert json.load(f)['batch_size'] == 4


def test_checkpoint_restore_skips_non_finite_and_halt(tmp_path):
    """A restore walks the entries newest first, skipping one with a
    non-finite value; `-halt` entries are invisible to it; retention keeps
    the newest `keep`; and a restore brings back weights, RMSProp slots and
    the step."""
    cfg = Config(multiclasses=False, **TINY).derive('train')
    params, aux = bridge.random_jax_params(cfg, 2, gf_dim=8, critics=True,
                                           df_dim=8)

    def fresh():
        return create_train_state(bridge.load_jax_params(
            Networks(cfg, gf_dim=8, df_dim=8, critics=True), params, aux))

    state = fresh()
    with torch.no_grad():
        state.slots['g1']['G1.g_lin_0.Matrix'].fill_(3.0)
    state.step = 7
    d = str(tmp_path)
    ckpt.save(d, 2, state)
    with torch.no_grad():
        state.nets.E.FC8_mu.w.fill_(float('nan'))
    ckpt.save(d, 5, state)
    ckpt.save_halt(d, 6, state)
    restored = fresh()
    loaded, counter, _ = ckpt.load(d, restored)
    assert loaded and counter == 2 and restored.step == 7
    assert ckpt.halt_steps(d) == [6] and ckpt.steps(d)[-1] == 5
    assert float(restored.slots['g1']['G1.g_lin_0.Matrix'][0, 0]) == 3.0
    assert torch.isfinite(restored.nets.E.FC8_mu.w).all()
    for s in (8, 11, 14, 17, 20):
        ckpt.save(d, s, restored, keep=5)
    assert ckpt.steps(d) == [8, 11, 14, 17, 20]
