"""The port's TF-checkpoint importer (`edgegan_torch/convert.py`)
against the JAX package's (`edgegan_tpu/convert.py`), at the default
14-class configuration (the released checkpoint's architecture), on
synthetic arrays: no TensorFlow checkpoint is needed.

- The rules cover every parameter and state vector of the port's
  networks, and nothing else.
- An npz written by JAX's `export_tf_npz` imports bit for bit as JAX's
  `import_tf_npz` imports it, and the port's export -> import round trip
  is bit-exact (and its export equals JAX's, name for name and byte for
  byte).
- The imported trees load into the port's networks.
- `tf_variable_names` equals tests/fixtures/tf_variable_names_14class.txt.
- A missing variable, a wrong shape and a non-default architecture raise.
"""
import dataclasses
import os

import numpy as np
import pytest

from edgegan_tpu import convert as jconvert
from edgegan_tpu.core.config import Config as JConfig
from edgegan_torch import bridge, convert
from edgegan_torch.core.config import Config
from edgegan_torch.train.networks import Networks
from test_torch_variants import few_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'tf_variable_names_14class.txt')


@pytest.fixture(scope='module')
def config():
    return Config().derive('train')


@pytest.fixture(scope='module')
def trees(config):
    return bridge.random_jax_params(config, 11, critics=True)


@pytest.fixture(scope='module')
def exported(tmp_path_factory, config, trees):
    """The same trees exported by JAX's and by the port's export_tf_npz."""
    d = tmp_path_factory.mktemp('tf')
    jpath, ppath = str(d / 'jax.npz'), str(d / 'port.npz')
    jconvert.export_tf_npz(*trees, JConfig().derive('train'), jpath)
    convert.export_tf_npz(*trees, config, ppath)
    return jpath, ppath


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb), sorted(set(la) ^ set(lb))[:5]
    for k in la:
        assert la[k].dtype == lb[k].dtype == np.float32, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


def test_rules_cover_every_port_parameter(config):
    p_rules, a_rules = convert.param_rules(config)
    with_critics = Networks(config, critics=True)
    params = {path for path, _ in bridge.param_paths(with_critics).values()}
    assert {r[0] for r in p_rules} == params
    _, aux = bridge.export_jax_params(with_critics)
    aux_paths = {(p[0],) + p[2:] for p, _ in _leaves(aux)}
    assert {r[0] for r in a_rules} == aux_paths


def test_import_of_jax_export_equals_jax_import(exported, config):
    jpath, _ = exported
    want = jconvert.import_tf_npz(jpath, JConfig().derive('train'),
                                  validate=False)
    got = convert.import_tf_npz(jpath, config)
    for w, g in zip(want, got):
        _assert_trees_equal(w, g)


def test_export_import_round_trip(exported, config, trees):
    jpath, ppath = exported
    with np.load(jpath) as j, np.load(ppath) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].tobytes() == p[k].tobytes(), k
    params, aux = convert.import_tf_npz(ppath, config)
    _assert_trees_equal(params, trees[0])
    _assert_trees_equal(aux, trees[1])
    nets = bridge.load_jax_params(Networks(config, critics=True), params,
                                  aux)
    _assert_trees_equal(bridge.export_jax_params(nets)[0], trees[0])


def test_tf_variable_names_match_fixture(config):
    with open(FIXTURE) as f:
        assert f.read().splitlines() == convert.tf_variable_names(config)


@pytest.mark.parametrize('fault', ['missing', 'shape'])
def test_bad_npz_raises(tmp_path, exported, config, fault):
    with np.load(exported[1]) as npz:
        data = {k: npz[k] for k in npz.files}
    if fault == 'missing':
        data.pop('G1/g_lin_0/Matrix')
    else:
        data['G1/g_lin_0/Matrix'] = data['G1/g_lin_0/Matrix'][:, :8]
    path = str(tmp_path / f'{fault}.npz')
    np.savez(path, **data)
    if fault == 'missing':
        with pytest.raises(KeyError, match='missing'):
            convert.import_tf_npz(path, config)
    else:
        with pytest.raises(ValueError, match='mismatch'):
            convert.import_tf_npz(path, config)


@pytest.mark.parametrize('deviation', [
    {'if_resnet_g': True}, {'if_resnet_d': True}, {'if_resnet_e': False}])
def test_nondefault_architecture_rejected(tmp_path, trees, deviation):
    cfg = dataclasses.replace(Config(), **deviation).derive('train')
    with pytest.raises(convert.UnsupportedArchitecture, match='default'):
        convert.param_rules(cfg)
    with pytest.raises(convert.UnsupportedArchitecture, match='default'):
        convert.import_tf_npz('/nonexistent.npz', cfg)
    with pytest.raises(convert.UnsupportedArchitecture, match='default'):
        convert.export_tf_npz(*trees, cfg, str(tmp_path / 'x.npz'))
    with pytest.raises(convert.UnsupportedArchitecture, match='default'):
        convert.tf_variable_names(cfg)
