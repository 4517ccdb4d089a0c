"""The port's evaluation (`edgegan_torch/evaluation.py`,
`python -m edgegan_torch.cli.evaluate`) against the JAX package's
(`edgegan_tpu/evaluation.py`, scripts/evaluate.py), on the CPU.

- The Frechet math, `fid_from_features`, `compute_fid` and
  `reconstruction_metrics` on seeded numpy features: rtol 1e-9.
- `Classifier.forward(..., return_features=True)` against the JAX
  classifier with the same weights at a small size: atol 2e-4.
- The pinned extractor (docs/fid_extractor.npz, the repository's trained
  classifier) against JAX's `pinned_extractor` on 8 seeded 64x64 images
  and on 128x128 ones (the resize branch): 3e-4 of the largest |feature|.
- `cli.evaluate` on a checkpoint that the port's `cli.train` wrote, with
  the in-run and the pinned extractor: its JSON keys are the JAX
  script's (run once on the same weights, in-run), and its `classifier_fid` is JAX's
  `fid_from_features` of JAX-extracted features of the port's returned
  reals and fakes within rtol 1e-3 (plus half the last of the 4 decimals
  both scripts round to). The two scripts' FIDs differ: each draws the
  encoder's noise from its own generator.
- The single-class refusal, and `inception_extractor(None)`.
"""
import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu import checkpoint as jckpt
from edgegan_tpu import evaluation as jeval
from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.train import Networks as JNetworks
from edgegan_tpu.train.state import TrainState as JTrainState
from edgegan_torch import bridge, evaluation
from edgegan_torch import checkpoint as ckpt
from edgegan_torch.cli import evaluate as evaluate_cli
from edgegan_torch.cli import train as train_cli
from edgegan_torch.core.config import Config
from edgegan_torch.models.classifier import Classifier
from test_torch_test_cli import SIZE, SIZE_FLAGS, _write_tree
from test_torch_variants import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = os.path.join(ROOT, 'docs', 'fid_extractor.npz')
MATH_RTOL = 1e-9
FEATURE_ATOL = 2e-4
PINNED_TOL = 3e-4      # of the largest |feature|
FID_RTOL = 1e-3
FID_ROUNDING = 5e-5    # both scripts print the FID to 4 decimals
# the train split (8 pairs: 2 steps of 4) and a held-out split (12 pairs)
TRAIN_TREE = (('0', 3), ('1', 3), ('2', 2))
HELDOUT_TREE = (('0', 4), ('1', 4), ('2', 4))


def _features(seed, n=64, d=6):
    rng = np.random.RandomState(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d))


@pytest.mark.parametrize('case', ['frechet_distance', 'fid_from_features',
                                  'compute_fid', 'reconstruction_metrics'])
def test_math_matches_jax(case):
    a, b = _features(0), _features(1) + 0.3
    if case == 'frechet_distance':
        args = (*jeval.compute_statistics(a), *jeval.compute_statistics(b))
        for x, y in zip(evaluation.compute_statistics(a),
                        jeval.compute_statistics(a)):
            np.testing.assert_allclose(x, y, rtol=MATH_RTOL, atol=0)
    elif case == 'compute_fid':
        rng = np.random.RandomState(2)
        real = rng.uniform(-1, 1, (40, 4, 4, 3)).astype(np.float32)
        fake = (rng.uniform(-1, 1, (40, 4, 4, 3)) * 0.5).astype(np.float32)

        def extractor(batch):
            return batch.reshape(len(batch), -1)[:, :8]
        args = (real, fake, extractor, 16)
    else:
        args = (a, b)
    got = getattr(evaluation, case)(*args)
    want = getattr(jeval, case)(*args)
    if case == 'reconstruction_metrics':
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    np.testing.assert_allclose(got, want, rtol=MATH_RTOL, atol=0)


def test_return_features_matches_jax():
    cfg = Config(**SIZE).derive('train')
    params, aux = bridge.random_jax_params(cfg, 2, critics=True)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jcls = JNetworks(JConfig(**SIZE).derive('train')).classifier
    want = jax.jit(lambda v, x: jcls.apply(v, x, return_features=True))(
        {'params': params['D2'], **aux['D2']}, x)
    cls = bridge.load_classifier(Classifier(cfg.num_classes), params['D2'],
                                 aux['D2'])
    with torch.no_grad():
        got = cls(torch.from_numpy(x).permute(0, 3, 1, 2),
                  return_features=True)
        plain = cls(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 4 and len(plain) == 3
    assert got[3].shape == (2, 768)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FEATURE_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), plain[2].numpy())


@pytest.fixture(scope='module')
def jax_pinned():
    """JAX's pinned extractor, made once (one jitted function)."""
    return jeval.pinned_extractor(PINNED)


@pytest.mark.parametrize('size', [64, 128])
def test_pinned_extractor_matches_jax(jax_pinned, size):
    x = np.random.RandomState(size).uniform(-1, 1, (8, size, size, 3))
    x = x.astype(np.float32)
    want = jax_pinned(x)
    got = evaluation.pinned_extractor(PINNED, 'cpu')(x)
    assert got.shape == want.shape == (8, 768)
    assert np.abs(got - want).max() <= PINNED_TOL * np.abs(want).max()


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A port checkpoint (counter 2) from `cli.train`, the same trees as
    a JAX checkpoint, and a held-out split: (data, outputs root)."""
    data = str(tmp_path_factory.mktemp('data'))
    _write_tree(data, phase='train', tree=TRAIN_TREE, seed=3)
    _write_tree(data, phase='heldout', tree=HELDOUT_TREE, seed=4)
    out = str(tmp_path_factory.mktemp('out'))
    train_cli.main(['--device', 'cpu', '--dataroot', data, '--dataset',
                    'ds', '--outputsroot', out, '--name', 'port',
                    '--batch_size', '4', '--image_dis_size', '32',
                    '--edge_dis_size', '32', '--epoch', '1',
                    '--save_checkpoint_frequency', '3'] + SIZE_FLAGS)
    loaded, counter, raw = ckpt.load_raw(
        os.path.join(out, 'port', 'checkpoints'))
    assert loaded and counter == 2
    # every network has an aux tree in JAX's state, the encoder's empty
    # (a TrainState keeps it through Orbax)
    aux = {net: raw['aux'].get(net, {}) for net in raw['params']}
    jckpt.save(os.path.join(out, 'jax', 'checkpoints'), counter,
               JTrainState(step=jnp.asarray(counter, jnp.int32),
                           params=raw['params'], aux=aux, opt_states={}))
    return data, out, raw


def _eval_args(data, out, name, *extra):
    return ['--dataroot', data, '--dataset', 'ds', '--outputsroot', out,
            '--name', name, '--split', 'heldout', '--eval_batch', '4',
            '--limit', '12'] + SIZE_FLAGS + list(extra)


def _jax_script(argv):
    """scripts/evaluate.py's main on `argv` -> its printed JSON line."""
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    try:
        import evaluate as jax_evaluate
    finally:
        sys.path.pop(0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_evaluate.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope='module')
def jax_result(trained):
    """The JAX script's result on the JAX checkpoint, in-run extractor
    (run once: its keys are those of every mode)."""
    data, out, _ = trained
    return _jax_script(_eval_args(data, out, 'jax'))


@pytest.mark.parametrize('extractor', ['in-run', 'pinned'])
def test_evaluate_cli_matches_jax(trained, jax_result, jax_pinned, capsys,
                                  extractor):
    data, out, raw = trained
    extra = ['--extractor_npz', PINNED] if extractor == 'pinned' else []
    result, reals, fakes = evaluate_cli.evaluate(
        _eval_args(data, out, 'port', '--device', 'cpu', *extra))
    want = dict(jax_result)
    if extractor == 'pinned':  # the JAX script's values in that mode
        want.update(extractor=PINNED, extractor_step=None)
    assert list(result) == list(want)
    for k in ('checkpoint_step', 'extractor', 'extractor_step', 'split',
              'n_images', 'note'):
        assert result[k] == want[k], k
    assert result['n_images'] == 12 == len(reals) == len(fakes)
    assert reals.shape == fakes.shape == (12, 32, 32, 3)
    assert np.isfinite([result[k] for k in ('classifier_fid', 'l1', 'mse',
                                            'psnr_db')]).all()
    if extractor == 'pinned':
        jext = jax_pinned
    else:
        jext = jeval.classifier_extractor(
            JNetworks(JConfig(**SIZE).derive('test')), raw['params'],
            raw['aux'])
    fid = jeval.fid_from_features(jext(reals), jext(fakes))
    assert abs(result['classifier_fid'] - fid) <= (FID_RTOL * abs(fid)
                                                   + FID_ROUNDING)
    # the port's main prints that result as its one JSON line
    capsys.readouterr()
    evaluate_cli.main(_eval_args(data, out, 'port', '--device', 'cpu',
                                 *extra))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result


def test_evaluate_refuses_single_class(tmp_path):
    args = _eval_args(str(tmp_path), str(tmp_path), 'none', '--multiclasses',
                      'False')
    with pytest.raises(SystemExit) as port:
        evaluate_cli.evaluate(args + ['--device', 'cpu'])
    with pytest.raises(SystemExit) as ref:
        _jax_script(args)
    assert port.value.code == ref.value.code
    assert 'multiclass' in port.value.code


def test_inception_extractor_requires_weights():
    with pytest.raises(ValueError, match='weights'):
        evaluation.inception_extractor(None)
