"""The pinned FID extractor's trainer (`python -m
edgegan_torch.cli.train_extractor`) and its optimizer (`train.state.Adam`)
against the JAX package's (scripts/train_fid_extractor.py, optax.adam),
on the CPU.

- `Adam` against `optax.adam(2e-4)` on random trees, 5 steps: within
  1e-7 relative (it follows optax's order of operations; bit for bit
  here).
- Three classifier-only training steps from the same
  `bridge.random_jax_params` D2 trees (4 classes, batch 8, 32x32 photo
  halves) against the JAX script's step, written out here with
  `edgegan_tpu`'s classifier, `get_acgan_loss_focal` and `optax.adam`:
  each step's loss within rtol 1e-6, its accuracy equal, and the
  classifier's update within the step's own sensitivity, as
  tests/test_torch_train.py holds the GAN step: Adam divides every
  gradient by its own magnitude, so a gradient entry at the level of
  float32 rounding moves its parameter by up to the learning rate, and
  JAX's own update moves by far more than the port's distance when its
  inputs are moved by 1e-6 relative. |port - JAX| (the norm of the
  update's difference) <= SENSITIVITY_X x the largest of three such
  jittered JAX runs + PARAM_FLOOR x the norm of the update. The same
  with both classifier switches on: the port's layers then take K5's,
  K3's and K4's plain versions (counted by spies: 14, 4 and 4 calls a
  step).
- An npz written by the trainer (2 steps on the CPU at the small size)
  reads in `edgegan_tpu.evaluation.pinned_extractor`, whose features of
  the port's npz are the port's within 1e-3 of the largest |feature|; its
  keys, float16 leaves and untouched `aux`; the sidecar has the JAX
  script's keys (those of docs/fid_extractor.npz.json).
- The entry point refuses `cuda` without a card.
"""
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgegan_tpu import evaluation as jeval
from edgegan_tpu import losses as JL
from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.train import Networks as JNetworks
from edgegan_torch import bridge
from edgegan_torch.cli import train_extractor as te
from edgegan_torch.core.config import Config
from edgegan_torch.data.genshapes import stage
from edgegan_torch.models.classifier import Classifier
from edgegan_torch.ops import kernels
from edgegan_torch.train.state import Adam
from test_torch_variants import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(num_classes=4, output_height=32, output_width=64,
            input_height=32, input_width=64, seed=te.SEED)
BATCH = 8
STEPS = 3
ADAM_RTOL = 1e-7
LOSS_RTOL = 1e-6
SENSITIVITY_X = 4.0       # as tests/test_torch_train.py
PARAM_FLOOR = 2e-3        # relative to the norm of the update
FEATURE_TOL = 1e-3        # of the largest |feature|
SWITCHES = ('EDGEGAN_PALLAS_PRELU', 'EDGEGAN_PALLAS_GATE')
PLAIN = ('prelu_bwd_plain', 'mru_gate_blend_plain', 'mru_gate_bwd_plain')


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (), (2, 3, 4, 5)]
    start = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    tx = optax.adam(2e-4)
    jp = [jnp.asarray(p) for p in start]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in start]
    opt = Adam(2e-4)
    state = opt.init(tp)
    for _ in range(5):
        grads = [np.asarray(rng.standard_normal(s)
                            * 10.0 ** rng.uniform(-4, 1), np.float32)
                 for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [torch.from_numpy(g) for g in grads], state)
        for got, want in ((tp, jp), (state.mu, jstate[0].mu),
                          (state.nu, jstate[0].nu)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=ADAM_RTOL, atol=0)
    assert state.count == int(jstate[0].count) == 5


def _flat(tree):
    flat = bridge._flatten(tree)
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat)])


@pytest.fixture(scope='module')
def runs():
    """STEPS steps of the JAX script's step (on the batches as they are
    and on three jittered copies) and of the port's, switches off and on:
    (initial params, JAX [(loss, acc, params)], jittered JAX runs, {switch
    state: (port runs, plain-version calls)})."""
    cfg = Config(**SIZE).derive('train')
    params, aux = bridge.random_jax_params(cfg, cfg.seed, critics=True)
    params0, aux0 = params['D2'], aux['D2']
    jcls = JNetworks(JConfig(**SIZE).derive('train')).classifier
    tx = optax.adam(2e-4)
    half_w, width, n = SIZE['output_width'] // 2, SIZE['output_width'], 4

    @jax.jit
    def train_step(params, opt_state, images, labels):
        # scripts/train_fid_extractor.py:102-117
        photos = images[:, :, half_w:width, :]

        def loss_fn(p):
            _, _, logits = jcls.apply({'params': p, **aux0}, photos)
            _, loss_d = JL.get_acgan_loss_focal(logits, labels, logits,
                                                labels, n)
            acc = jnp.mean((jnp.argmax(logits, -1) == labels)
                           .astype(jnp.float32))
            return loss_d, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    rng = np.random.RandomState(0)
    batches = [(rng.uniform(-1, 1, (BATCH, 32, 64, 3)).astype(np.float32),
                rng.randint(0, n, BATCH).astype(np.int32))
               for _ in range(STEPS)]

    def jax_run(jitter=None):
        p = jax.tree.map(jnp.asarray, params0)
        o = tx.init(p)
        out = []
        for images, labels in batches:
            if jitter is not None:
                images = (images * (1 + 1e-6 * jitter.standard_normal(
                    images.shape))).astype(np.float32)
            p, o, loss, acc = train_step(p, o, images, labels)
            out.append((float(loss), float(acc),
                        jax.tree.map(np.asarray, p)))
        return out

    ref = jax_run()
    jittered = [jax_run(np.random.RandomState(s)) for s in (97, 98, 99)]

    def port_run(on):
        calls = dict.fromkeys(PLAIN, 0)

        def spy(name):
            real = getattr(kernels, name)

            def counted(*args):
                calls[name] += 1
                return real(*args)
            return counted

        classifier = bridge.load_classifier(Classifier(n), params0, aux0)
        step = te.make_train_step(classifier, cfg)
        env = {k: '1' for k in SWITCHES} if on else {}
        out = []
        with mock.patch.dict(os.environ, env), \
                mock.patch.multiple(kernels, **{k: spy(k) for k in PLAIN}):
            for k in SWITCHES:
                if not on:
                    os.environ.pop(k, None)
            for images, labels in batches:
                loss, acc = step(torch.from_numpy(images),
                                 torch.from_numpy(labels).long())
                out.append((float(loss), float(acc),
                            bridge.export_classifier(classifier)[0]))
        return out, calls

    return params0, ref, jittered, {on: port_run(on) for on in (False, True)}


@pytest.mark.parametrize('switches', ['off', 'on'])
def test_extractor_steps_match_jax(runs, switches):
    params0, ref, jittered, port = runs
    on = switches == 'on'
    got, calls = port[on]
    assert calls == {'prelu_bwd_plain': 14 * STEPS * on,
                     'mru_gate_blend_plain': 4 * STEPS * on,
                     'mru_gate_bwd_plain': 4 * STEPS * on}
    start = _flat(params0)
    for k, ((loss, acc, params), (jloss, jacc, jparams)) in enumerate(
            zip(got, ref)):
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL,
                                   err_msg=f'step {k + 1}')
        assert acc == jacc, f'step {k + 1}'
        dj = _flat(jparams) - start
        dist = np.linalg.norm(_flat(params) - start - dj)
        own = max(np.linalg.norm(_flat(run[k][2]) - start - dj)
                  for run in jittered)
        norm = np.linalg.norm(dj)
        assert dist <= SENSITIVITY_X * own + PARAM_FLOOR * norm, (
            f'step {k + 1}: port {dist:.3g}, jittered JAX {own:.3g}, update '
            f'norm {norm:.3g}')


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The trainer's npz after 2 steps on the CPU at the small size, on a
    staged genshapes tree of 4 classes x 4 train pairs (2 batches) and 1
    held-out pair each (one batch of 4)."""
    root = tmp_path_factory.mktemp('extractor')
    data = str(root / 'data')
    stage(data, seed=3, train_per_class=4, test_per_class=1, num_classes=4)
    out = str(root / 'ext' / 'fid_extractor.npz')
    meta, losses = te.train(2, out, data, 'cpu', config=Config(
        **SIZE).derive('train'), batch=BATCH)
    assert len(losses) == 2 and np.isfinite(losses).all()
    return out, meta


def test_trained_npz_reads_in_jax(trained):
    out, _ = trained
    cfg = Config(**SIZE).derive('train')
    params, aux = bridge.random_jax_params(cfg, cfg.seed, critics=True)
    want_keys = set(bridge.flatten_npz(params=params['D2'], aux=aux['D2']))
    with np.load(out) as data:
        stored = {k: data[k] for k in data.files}
    assert set(stored) == want_keys
    assert all(v.dtype == np.float16 for v in stored.values())
    # the spectral-norm vectors are never advanced
    for k, v in bridge.flatten_npz(aux=aux['D2']).items():
        np.testing.assert_array_equal(stored[k], v.astype(np.float16))
    x = np.random.RandomState(5).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    want = jeval.pinned_extractor(out)(x)
    from edgegan_torch.evaluation import pinned_extractor
    got = pinned_extractor(out, 'cpu')(x)
    assert got.shape == want.shape == (4, 768)
    assert np.abs(got - want).max() <= FEATURE_TOL * np.abs(want).max()


def test_sidecar_has_the_jax_script_keys(trained):
    out, meta = trained
    with open(out + '.json') as f:
        written = json.load(f)
    with open(os.path.join(ROOT, 'docs', 'fid_extractor.npz.json')) as f:
        jax_sidecar = json.load(f)
    assert written == meta
    assert list(written) == list(jax_sidecar)
    assert list(written['config']) == list(jax_sidecar['config'])
    assert written['config'] == {k: SIZE[k] for k in written['config']}
    assert (written['seed'], written['steps'], written['feature_dim'],
            written['optimizer'], written['loss']) == (
        te.SEED, 2, 768, jax_sidecar['optimizer'], jax_sidecar['loss'])
    assert written['artifact_bytes'] == os.path.getsize(out)
    assert 0.0 <= written['heldout_accuracy'] <= 1.0


def test_entry_point_needs_a_card_unless_cpu(tmp_path):
    args = te.parse_args([])
    assert (args.steps, args.device) == (1500, 'cuda')
    assert not os.path.abspath(args.out_npz).startswith(
        os.path.join(ROOT, 'docs'))
    with pytest.raises(SystemExit, match='no CUDA device'):
        te.main(['2', str(tmp_path / 'x.npz'), str(tmp_path / 'data')])
    assert not os.path.exists(tmp_path / 'x.npz')
