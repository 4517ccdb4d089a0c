"""The model variants through the training step, the bridge and the
port's entry points, and the hires configuration's shapes (128x128
halves, 128x256 pairs), on the CPU.

- One faithful step with the resnet generator, the resnet critic with
  batch norm and the convnet encoder against JAX's step, within the
  step's own sensitivity (tests/test_torch_train.py's harness), on the
  smallest step graph (the joint critic, no classifier): the one JAX step
  compilation of the variants' tests.
- The bridge's round trip of JAX's trees with batch norm in every block
  (each block's moving statistics under its own scope).
- `python -m edgegan_torch.cli.train` -> checkpoint -> resume ->
  `cli.test` with every architecture flag away from its default at once
  (at the tiny size of tests/test_torch_train.py).
- The hires shapes through a narrow bundle at batch 1 against the JAX
  package: the joint resnet critic flattens 1x2 (128x256 -> 8x16 ->
  1x2), the encoder takes a 128x128 sketch, and one faithful step calls
  K1's and K2's dispatch as often as `chip_smoke.py` expects on the
  card.
"""
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
from edgegan_torch.cli import test as test_cli
from edgegan_torch.cli import train as train_cli
from edgegan_torch.core.config import Config
from edgegan_torch.ops import kernels
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from edgegan_torch.train.step import make_draws, make_train_step
from edgegan_torch.utils import metrics_io
from test_torch_critics import _nchw
from test_torch_test_cli import SIZE_FLAGS, _pngs, _write_tree
from test_torch_train import (METRIC_FLOOR, PARAM_FLOOR, SENSITIVITY_X,
                              TINY, _flat, _tree_np, jax_draws, make_batch)
from test_torch_variants import RESNET, SMALL, _norms, few_threads  # noqa: F401

HIRES = dict(input_height=128, input_width=256, output_height=128,
             output_width=256, image_dis_size=128, edge_dis_size=128)
WIDTH = dict(gf_dim=8, df_dim=8)
# every architecture flag away from its default at once
VARIANT_FLAGS = dict(**RESNET, **_norms('batch'))
FWD_ATOL = 2e-4


def _flags(kw):
    out = []
    for k, v in kw.items():
        out += [f'--{k}', str(v)] if not isinstance(v, bool) or v else \
            [f'--no{k}']
    return out


# the step's variants on its smallest graph (one JAX compilation): the
# joint critic alone, no classifier; tests/test_torch_train.py holds the
# patch critics and the classifier in the default step
STEP = dict(host_z=True, **TINY, **RESNET, D_norm='batch',
            multiclasses=False, use_image_discriminator=False,
            use_edge_discriminator=False)
STEP_NETS = ['G1', 'G2', 'D', 'E']
STEP_GROUPS = {'d': 'D', 'g1': 'G1', 'g2': 'G2', 'e': 'E'}


@pytest.fixture(scope='module')
def step_runs():
    """One faithful step of STEP at the tiny configuration, from the same
    weights and JAX's draws: JAX's, JAX's on inputs jittered by 1e-6
    (three runs), and the port's."""
    jcfg, cfg = JConfig(**STEP).derive('train'), Config(**STEP).derive(
        'train')
    jnets = JNetworks(jcfg, **WIDTH)
    params0, aux0 = bridge.random_jax_params(cfg, 0, critics=True, **WIDTH)
    tx = make_optimizer(jcfg.learning_rate)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=params0,
                        aux=aux0, opt_states={g: tx.init(params0[n]) for
                                              g, n in STEP_GROUPS.items()})
    jstep = jax.jit(j_make_train_step(jnets, jcfg))
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 0)

    def batch(jitter=None):
        images, z = make_batch(0, jitter)
        return images, z[:, :-1]   # single-class: no class column

    def jax_run(jitter):
        images, z = batch(jitter)
        st, m = jstep(state, jnp.asarray(images), jnp.asarray(z), rng)
        return {n: float(v) for n, v in m.items()}, _tree_np(st.params)

    ref = jax_run(None)
    jittered = [jax_run(np.random.RandomState(s)) for s in (97, 98, 99)]
    nets = bridge.load_jax_params(Networks(cfg, critics=True, **WIDTH),
                                  params0, aux0)
    images, z = batch()
    _, m = make_train_step(nets, cfg)(
        create_train_state(nets), torch.from_numpy(images),
        torch.from_numpy(z), jax_draws(jax.jit(jnets.encode), params0, aux0,
                                       rng))
    port = ({n: v.item() for n, v in m.items()},
            bridge.export_jax_params(nets)[0])
    return params0, ref, jittered, port


def test_variant_step_matches_jax(step_runs):
    """One faithful step with the resnet generators, the resnet critic
    with batch norm (its penalty differentiates `Residual2` and the batch
    statistics twice) and the convnet encoder (K1 forward, K2 backward in
    its update): the critic's loss (before its update) within rtol 1e-4,
    every metric finite, and every metric and every network's update
    within the step's own sensitivity, with tests/test_torch_train.py's
    limits: SENSITIVITY_X times the largest distance of a jittered JAX
    run from JAX's, plus a floor."""
    params0, (jm, jp), jittered, (pm, pp) = step_runs
    assert set(pm) == set(jm) and all(math.isfinite(v) for v in pm.values())
    np.testing.assert_allclose(pm['joint_dis_dloss'], jm['joint_dis_dloss'],
                               rtol=1e-4)
    bad = []
    for n in jm:
        d = abs(pm[n] - jm[n])
        own = max(abs(run[0][n] - jm[n]) for run in jittered)
        if d > SENSITIVITY_X * own + METRIC_FLOOR * max(1.0, abs(jm[n])):
            bad.append(f'{n}: port {d:.3g}, jittered JAX {own:.3g}')
    for net in STEP_NETS:
        start = _flat(params0[net])
        dj = _flat(jp[net]) - start
        d = np.linalg.norm(_flat(pp[net]) - start - dj)
        own = max(np.linalg.norm(_flat(run[1][net]) - start - dj)
                  for run in jittered)
        if d > SENSITIVITY_X * own + PARAM_FLOOR * np.linalg.norm(dj):
            bad.append(f'{net} update: port {d:.3g}, jittered JAX {own:.3g}')
    assert not bad, bad


def test_variants_train_resume_and_test(tmp_path):
    """`cli.train` with every architecture flag away from its default
    (resnet G, resnet D, convnet E, batch norm in their blocks; the joint
    critic only): one step saves at counter 2, a relaunch resumes there
    and takes one more, every metric finite; the checkpoint holds the
    variants' weights, every block's batch-norm statistics under its own
    scope; `cli.test` restores G1, G2 and E from it and writes both test
    images (`serve` restores them by the same `load_raw`, held in
    tests/test_torch_test_cli.py)."""
    root, out = str(tmp_path / 'data'), str(tmp_path / 'out')
    _write_tree(root, 'train', (('0', 2), ('1', 1), ('2', 1)))
    _write_tree(root, 'test', (('0', 1), ('2', 1)))
    # training the joint critic alone: the patch critics are the same
    # code for every variant, and tests/test_torch_train.py's CLI test
    # trains them
    args = ['--device', 'cpu', '--dataroot', root, '--dataset', 'ds',
            '--outputsroot', out, '--name', 'run'] + SIZE_FLAGS + _flags(
                VARIANT_FLAGS)
    train = args + ['--batch_size', '4', '--nouse_image_discriminator',
                    '--nouse_edge_discriminator', '--save_checkpoint_frequency',
                    '3', '--epoch', '1']
    train_cli.main(train)
    state = train_cli.main(train)
    assert state.step == 2
    log = os.path.join(out, 'run', 'logs', 'metrics.jsonl')
    assert metrics_io.read_resume_markers(log) == [2]
    rows = metrics_io.read_metrics(log)
    assert [r['step'] for r in rows] == [2, 3]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    loaded, counter, trees = ckpt.load_raw(os.path.join(out, 'run',
                                                        'checkpoints'))
    assert loaded and counter == 2
    assert {'g_resnet_4', 'g_lin_resnet_0'} <= set(trees['params']['G1'])
    assert 'd_linear_resnet_5' in trees['params']['D']
    assert 'e_convnet_512_6' in trees['params']['E']
    stats = trees['aux']['G1']['batch_stats']
    assert set(stats) == {'g_norm_0_mean', 'g_norm_0_var', 'g_resnet_1',
                          'g_resnet_2', 'g_resnet_3'}
    assert set(stats['g_resnet_1']) == {'norm1_mean', 'norm1_var',
                                        'norm2_mean', 'norm2_var'}
    assert set(trees['aux']['E']['batch_stats']) == {
        f'e_convnet_{n}_{i}' for i, n in enumerate(
            [128, 256, 512, 512, 512, 512], 1)}
    test_cli.main(args)
    pngs = _pngs(os.path.join(out, 'run', 'test_output'))
    assert len(pngs) == 2
    assert all(a.shape == (32, 128, 3) for a in pngs.values())


@pytest.mark.parametrize('arch', ['resnet', 'convnet'])
def test_bridge_round_trip_nests_batch_stats(arch):
    """A bundle with batch norm in every block (the variants' blocks with
    RESNET, the default blocks without): JAX's initialised trees load into
    the port with no missing or unused key and come back exactly. Every
    block's moving statistics sit under its own scope in `batch_stats`,
    so two blocks' `norm_mean` no longer fall on one key; and
    `random_jax_params` draws the trees JAX's init makes."""
    kw = dict(**SMALL, **_norms('batch'), **(RESNET if arch == 'resnet'
                                             else {}))
    cfg = Config(**kw).derive('train')
    jnets = JNetworks(JConfig(**kw).derive('train'), **WIDTH)
    params, aux = jax.eval_shape(jnets.init, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda s: (s.shape, s.dtype), (params, aux))
    rng = np.random.default_rng(5)
    params, aux = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), (params, aux))
    stats = {net: aux[net].get('batch_stats', {}) for net in aux}
    nested = [(net, k) for net, t in stats.items() for k, v in t.items()
              if isinstance(v, dict)]
    assert len(nested) >= 8, nested
    nets = bridge.load_jax_params(Networks(cfg, critics=True, **WIDTH),
                                  params, aux)
    got = bridge.export_jax_params(nets)
    assert jax.tree.structure(got) == jax.tree.structure((params, aux))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves((params, aux))))
    drawn = bridge.random_jax_params(cfg, 0, critics=True, **WIDTH)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), drawn) == shapes


@pytest.fixture(scope='module')
def hires():
    """The hires configuration with every architecture flag away from its
    default, 8 filters wide, in both packages, the same drawn weights."""
    kw = dict(batch_size=1, num_classes=3, z_dim=8, **HIRES, **RESNET)
    cfg = Config(**kw).derive('train')
    jnets = JNetworks(JConfig(**kw).derive('train'), **WIDTH)
    params, aux = bridge.random_jax_params(cfg, 4, critics=True, **WIDTH)
    nets = bridge.load_jax_params(Networks(cfg, critics=True, **WIDTH),
                                  params, aux)
    return jnets, params, aux, nets


def test_hires_shapes_match_jax(hires):
    """At 128x256 pairs, batch 1: the resnet generator makes a 128x128
    half; the joint resnet critic's linear reads 8 filters x 8 x 1 x 2
    (its 8x8 SAME pool leaves 1x2 of 8x16), the patch critics' 64 (1x1 of
    8x8); the convnet encoder maps a 128x128 sketch through seven
    stride-2 blocks to 1x1. The generator, the joint critic and the
    encoder within FWD_ATOL of JAX."""
    jnets, params, aux, nets = hires
    assert nets.D.d_linear_resnet_5.Matrix.shape == (1, 8 * 8 * 1 * 2)
    assert nets.D_patch2.d_linear_resnet_5.Matrix.shape == (1, 8 * 8)
    assert nets.E.FC8_mu.w.shape == (8, 512)
    rng = np.random.RandomState(5)
    z = rng.uniform(-1, 1, (1, nets.gen_input_dim)).astype(np.float32)
    pair = rng.uniform(-1, 1, (1, 128, 256, 3)).astype(np.float32)
    with torch.no_grad():
        edge = nets.G1(torch.from_numpy(z))
        assert edge.shape == (1, 3, 128, 128)
        np.testing.assert_allclose(
            edge.permute(0, 2, 3, 1).numpy(),
            np.asarray(jnets.generate(params, aux, jnp.asarray(z))[0]),
            atol=FWD_ATOL)
        got = nets.discriminate('D', _nchw(pair))
        ref = jnets.discriminate('D', params, aux, jnp.asarray(pair))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=FWD_ATOL)
        mu, log_sigma = nets.E.heads(_nchw(pair[:, :, :128]))
    _, jmu, jls = jnets.encode(params, aux, jnp.asarray(pair[:, :, :128]),
                               jax.random.PRNGKey(0))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=FWD_ATOL)
    np.testing.assert_allclose(log_sigma.numpy(), np.asarray(jls),
                               atol=FWD_ATOL)


def test_hires_step_calls_k1_k2_as_planned(monkeypatch):
    """One faithful hires step at batch 1, 8 filters wide, single-class,
    with the convnet generators and encoder (instance norm): K1's dispatch
    27 calls (7 generator forwards x 3 blocks + the encoder's 6 normed
    blocks) and K2's 18 (4 generator backwards x 3 + the encoder's 6), the
    counts `chip_smoke.py` holds the card's step to (its hires phase
    counts the classifier's K5, K3 and K4 on the card); every metric
    finite."""
    cfg = Config(batch_size=1, z_dim=8, if_resnet_e=False,
                 multiclasses=False, **HIRES).derive('train')
    params, aux = bridge.random_jax_params(cfg, 6, critics=True, **WIDTH)
    nets = bridge.load_jax_params(Networks(cfg, critics=True, **WIDTH),
                                  params, aux)
    calls = []
    for name in ('_forward', 'instance_norm_act_bwd'):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.uniform(-1, 1, (1, 128, 256, 3)).astype(
        np.float32))
    state, metrics = make_train_step(nets, cfg)(
        create_train_state(nets), images, torch.zeros(1, 0),
        make_draws(cfg, 1, torch.Generator().manual_seed(0), 'cpu'))
    assert (calls.count('_forward'), calls.count('instance_norm_act_bwd'),
            len(calls)) == (27, 18, 45)
    assert 'D2' not in nets.names and state.step == 1 and len(metrics) == 10
    assert all(math.isfinite(float(v)) for v in metrics.values())
