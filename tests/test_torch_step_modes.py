"""The port's training-step options against the JAX step: the fast step
(`update_mode='fast'`), the re-evaluated losses (`reference_metrics`) and
the spectral-norm update (`update_sn`), all three together, in float32
and in bfloat16 (one JAX compilation each).

The method is tests/test_torch_train.py's: the tiny configuration with
`host_z`, the same weights in both packages, the JAX step's own draws
handed to the port (with the three `reference_metrics` blend weights from
`fold_in(rng, 16 + i)`), and every metric and every network's update after
steps 1 and 2 held to JAX within SENSITIVITY_X (float32) or
SENSITIVITY_BF16_X (bfloat16) times JAX's own sensitivity plus a floor,
measured here by three runs of JAX on inputs jittered by 1e-6 (float32)
or BF16_JITTER (bfloat16) relative. A fast step amplifies rounding as the
faithful step does (the critics' gradient penalty comes first in both).
Fixed tolerances hold where no rounding reaches: the classifier, which
sees only the real images, within 1e-6 in float32, and the classifier's
spectral-norm vectors `u` within 1e-5 after two power iterations.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.train import Networks as JNetworks
from edgegan_tpu.train import make_train_step as j_make_train_step
from edgegan_torch import bridge
from edgegan_torch.core.config import Config
from edgegan_torch.ops import kernels
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from edgegan_torch.train.step import make_train_step
from test_torch_train import (BF16_JITTER, METRIC_FLOOR, NETS, PARAM_FLOOR,
                              SENSITIVITY_BF16_X, SWITCHES, TINY,
                              _check_within_sensitivity, _flat, _jax_state,
                              _tree_np, jax_draws, make_batch)
from test_torch_variants import few_threads  # noqa: F401

STEPS = 2
OPTIONS = dict(update_mode='fast', reference_metrics=True, update_sn=True)
U_ATOL = 1e-5
# the kernels' CPU dispatch, as the spies name them: K1, K2, K5, K3, K4
SPIED = ('_forward', 'instance_norm_act_bwd', 'prelu_bwd', 'mru_gate_blend',
         'mru_gate_bwd')


def _u(spectral):
    """The classifier's `u` vectors, flat, in a fixed order."""
    return _flat(spectral)


def _runs(dtype, switches):
    """STEPS steps of JAX, of JAX on jittered inputs (three runs) and of
    the port (with the classifier switches on if `switches`, counting the
    calls to each kernel's dispatch), all with OPTIONS: per step
    (metrics, params) and the classifier's `u` after the last step."""
    jcfg = JConfig(host_z=True, dtype=dtype, **TINY, **OPTIONS).derive(
        'train')
    cfg = Config(host_z=True, dtype=dtype, **TINY, **OPTIONS).derive('train')
    jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    scale = BF16_JITTER if dtype == 'bfloat16' else 1e-6
    jnets = JNetworks(jcfg)
    params0, aux0 = bridge.random_jax_params(cfg, 0, critics=True)
    jstep = jax.jit(j_make_train_step(jnets, jcfg))
    encode = jax.jit(jnets.encode)
    rngs = [jax.random.fold_in(jax.random.PRNGKey(3), k)
            for k in range(STEPS)]

    def jax_run(jitter):
        st, out = _jax_state(jcfg, params0, aux0), []
        for k in range(STEPS):
            images, z = make_batch(k, jitter, scale)
            st, m = jstep(st, jnp.asarray(images), jnp.asarray(z), rngs[k])
            out.append(({n: float(v) for n, v in m.items()},
                        _tree_np(st.params)))
        return out, _u(_tree_np(st.aux['D2']['spectral']))

    ref, ref_u = jax_run(None)
    jittered = [jax_run(np.random.RandomState(seed))[0]
                for seed in (97, 98, 99)]

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        if switches:
            for name in SWITCHES:
                mp.setenv(name, '1')
        for name in SPIED:
            fn = getattr(kernels, name)
            mp.setattr(kernels, name, lambda *a, _f=fn, _n=name:
                       calls.append(_n) or _f(*a))
        nets = bridge.load_jax_params(Networks(cfg, critics=True), params0,
                                      aux0)
        state = create_train_state(nets)
        step = make_train_step(nets, cfg)
        port, draws = [], []
        for k in range(STEPS):
            images, z = make_batch(k)
            draws.append(jax_draws(encode, params0, aux0, rngs[k], jdtype,
                                   evals=True))
            state, m = step(state, torch.from_numpy(images),
                            torch.from_numpy(z), draws[k])
            port.append(({n: v.item() for n, v in m.items()},
                         bridge.export_jax_params(nets)[0]))
    assert state.step == STEPS
    spectral = bridge.export_jax_params(nets)[1]['D2']['spectral']
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(spectral))
    return dict(params0=params0, aux0=aux0, u0=_u(aux0['D2']['spectral']),
                ref=ref, ref_u=ref_u, jittered=jittered, port=port,
                port_u=_u(spectral), calls=calls, draws=draws)


@pytest.fixture(scope='module')
def f32():
    return _runs('float32', switches=False)


@pytest.fixture(scope='module')
def bf16():
    return _runs('bfloat16', switches=True)


@pytest.mark.parametrize('k', range(STEPS))
def test_fast_step_matches_jax(f32, k):
    """Steps 1 and 2 of the fast step with the re-evaluated losses and the
    spectral-norm update, float32: every metric (the critics' and the
    generators' losses re-evaluated after the step with fresh blends,
    `loss_d_ac` and `zl_loss` from the step) and every network's update
    within the step's own sensitivity; the classifier within 1e-6 and its
    loss within rtol 1e-5."""
    (jm, jp), (pm, pp) = f32['ref'][k], f32['port'][k]
    assert set(pm) == set(jm) and all(math.isfinite(v) for v in pm.values())
    np.testing.assert_allclose(pm['loss_d_ac'], jm['loss_d_ac'], rtol=1e-5)
    np.testing.assert_allclose(_flat(pp['D2']), _flat(jp['D2']), rtol=0,
                               atol=1e-6)
    _check_within_sensitivity(f32['params0'], f32['ref'], f32['jittered'],
                              f32['port'], k)


def test_reference_metrics_change_only_what_is_reported(f32):
    """`reference_metrics` re-evaluates the losses after the step and
    changes nothing else: from the same weights and draws as the float32
    run's first step, a step without it leaves bitwise equal weights,
    reports the same `loss_d_ac` and `zl_loss` (not re-evaluated, as in
    JAX), and reports other critic and generator losses (the losses the
    groups trained on; the post-step values are held to JAX's in
    test_fast_step_matches_jax)."""
    cfg = Config(host_z=True, **TINY, **dict(
        OPTIONS, reference_metrics=False)).derive('train')
    nets = bridge.load_jax_params(Networks(cfg, critics=True),
                                  f32['params0'], f32['aux0'])
    images, z = make_batch(0)
    _, m = make_train_step(nets, cfg)(
        create_train_state(nets), torch.from_numpy(images),
        torch.from_numpy(z), f32['draws'][0])
    m_off = {n: v.item() for n, v in m.items()}
    m_on, p_on = f32['port'][0]
    np.testing.assert_array_equal(_flat(bridge.export_jax_params(nets)[0]),
                                  _flat(p_on))
    assert set(m_on) == set(m_off)
    for n in m_on:
        if n in ('loss_d_ac', 'zl_loss'):
            assert m_on[n] == m_off[n], n
        else:
            assert m_on[n] != m_off[n], n


def test_update_sn_matches_jax(f32):
    """After two steps every spectral-norm `u` of the classifier (its 20
    layers, `disc_head` included) is JAX's within 1e-5, and has moved."""
    assert f32['port_u'].shape == f32['ref_u'].shape == f32['u0'].shape
    np.testing.assert_allclose(f32['port_u'], f32['ref_u'], rtol=0,
                               atol=U_ATOL)
    assert np.abs(f32['ref_u'] - f32['u0']).max() > 100 * U_ATOL


@pytest.mark.parametrize('k', range(STEPS))
def test_bf16_fast_step_matches_jax_bf16(f32, bf16, k):
    """The bfloat16 fast step with both options and both classifier
    switches against JAX's bfloat16 step: every metric and every network's
    update within SENSITIVITY_BF16_X times JAX's own bfloat16 sensitivity
    plus the float32 floors; the classifier's update is also allowed JAX's
    own bfloat16 error, its distance from JAX's float32 update (as in
    tests/test_torch_train.py)."""
    params0 = bf16['params0']
    (jm, jp), (pm, pp) = bf16['ref'][k], bf16['port'][k]
    fp = f32['ref'][k][1]
    assert set(pm) == set(jm) and all(math.isfinite(v) for v in pm.values())
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(pp))
    bad = []
    for n in jm:
        d = abs(pm[n] - jm[n])
        own = max(abs(run[k][0][n] - jm[n]) for run in bf16['jittered'])
        if d > SENSITIVITY_BF16_X * own + METRIC_FLOOR * max(1.0, abs(jm[n])):
            bad.append(f'{n}: port {d:.3g}, jittered JAX {own:.3g}')
    for net in NETS:
        start = _flat(params0[net])
        dj = _flat(jp[net]) - start
        d = np.linalg.norm(_flat(pp[net]) - start - dj)
        own = max(np.linalg.norm(_flat(run[k][1][net]) - start - dj)
                  for run in bf16['jittered'])
        if net == 'D2':
            own = max(own, np.linalg.norm(_flat(fp[net]) - start - dj))
        if d > SENSITIVITY_BF16_X * own + PARAM_FLOOR * np.linalg.norm(dj):
            bad.append(f'{net} update: port {d:.3g}, JAX sensitivity '
                       f'{own:.3g}')
    assert not bad, bad


def test_bf16_update_sn_matches_jax_bf16(bf16):
    """In bfloat16 the `u` vectors stay float32 (checked in the run) and
    match JAX's within 1e-5: both take the power iteration on the float32
    weights."""
    np.testing.assert_allclose(bf16['port_u'], bf16['ref_u'], rtol=0,
                               atol=U_ATOL)


def test_fast_step_launches(bf16):
    """Per fast step with `reference_metrics`, `update_sn` and both
    classifier switches, counted by spies on the CPU dispatch: K1 24 (the
    critics' fakes, the generator update's forward and the re-evaluation's
    two generator forwards, 6 each), K2 6 (one generator update), K5 28
    (14 PReLUs x 2 classifier backwards), K3 12 (4 gates x 3 classifier
    forwards: group 4, the generator update, the re-evaluation) and K4 8.
    `update_sn` adds none: it runs no forward."""
    calls = bf16['calls']
    assert {n: calls.count(n) / STEPS for n in set(calls)} == {
        '_forward': 24, 'instance_norm_act_bwd': 6, 'prelu_bwd': 28,
        'mru_gate_blend': 12, 'mru_gate_bwd': 8}
