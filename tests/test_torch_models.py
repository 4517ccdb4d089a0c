"""The port's networks and inference forward against the JAX package on
the same weights (drawn by `bridge.random_jax_params`) and the same
encoder eps, recovered from the JAX encoder's own draw."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.infer import make_test_forward as j_make_test_forward
from edgegan_tpu.train.networks import Networks as JNetworks
from edgegan_torch import bridge
from edgegan_torch.core.config import Config
from edgegan_torch.infer import make_test_forward
from edgegan_torch.train.networks import Networks
from test_torch_variants import few_threads  # noqa: F401

SMALL = dict(num_classes=4, z_dim=8, output_height=32, output_width=64,
             input_height=32, input_width=64)
FULL = dict(num_classes=14, z_dim=100, output_height=64, output_width=128,
            input_height=64, input_width=128)


class Pair:
    """One configuration in both packages, with shared weights."""

    def __init__(self, kw, gf_dim, seed=0):
        self.cfg = Config(**kw).derive('test')
        self.jcfg = JConfig(**kw).derive('test')
        self.jnets = JNetworks(self.jcfg, gf_dim=gf_dim)
        self.params, self.aux = bridge.random_jax_params(self.cfg, seed,
                                                         gf_dim)
        self.nets = bridge.load_jax_params(
            Networks(self.cfg, gf_dim=gf_dim), self.params, self.aux)
        self._encode = jax.jit(functools.partial(self.jnets.encode,
                                                 self.params, self.aux))

    def jax_eps(self, left, rng):
        """The two eps the JAX forward draws from `rng` (infer.py:42)."""
        out = []
        for key in jax.random.split(rng):
            z, mu, ls = self._encode(left, key)
            out.append(float(np.mean((np.asarray(z) - np.asarray(mu))
                                     / np.exp(np.asarray(ls)))))
        return torch.tensor(out)

    def inputs(self, batch, seed=1):
        rng = np.random.RandomState(seed)
        h, w = self.cfg.output_height, self.cfg.output_width
        x = rng.uniform(-1, 1, (batch, h, w, 3)).astype(np.float32)
        classes = rng.randint(0, self.cfg.num_classes, batch)
        return x, classes


@pytest.fixture(scope='module')
def small():
    return Pair(SMALL, gf_dim=8)


def _left(pair, x):
    return x[:, :pair.cfg.output_height, :pair.cfg.output_width // 2]


def test_random_params_have_the_jax_layout():
    """random_jax_params draws exactly the trees Networks.init makes
    (names, shapes, dtypes), for G and E."""
    jcfg = JConfig(**SMALL).derive('test')
    jnets = JNetworks(jcfg, gf_dim=8)
    key = jax.random.PRNGKey(0)
    shapes = {
        'G1': jax.eval_shape(jnets.edge_generator.init, key,
                             jnp.zeros((2, jnets.gen_input_dim))),
        'E': jax.eval_shape(
            lambda k, x: jnets.encoder.init({'params': k, 'noise': k}, x),
            key, jnp.zeros((2, 32, 32, 3))),
    }
    params, aux = bridge.random_jax_params(Config(**SMALL).derive('test'),
                                           0, gf_dim=8)
    for net, variables in shapes.items():
        want = jax.tree.map(lambda s: (s.shape, s.dtype), variables)
        got = jax.tree.map(lambda a: (a.shape, a.dtype),
                           {'params': params[net], **aux[net]})
        assert got == want, net
    assert params['G1'].keys() == params['G2'].keys()


def test_bridge_round_trip(tmp_path, small):
    params, aux = bridge.export_jax_params(small.nets)
    assert jax.tree.all(jax.tree.map(np.array_equal, params, small.params))
    assert jax.tree.all(jax.tree.map(np.array_equal, aux, small.aux))
    path = str(tmp_path / 'w.npz')
    bridge.save_npz(path, params, aux)
    p2, a2 = bridge.load_npz(path)
    assert jax.tree.all(jax.tree.map(np.array_equal, p2, small.params))
    assert jax.tree.all(jax.tree.map(np.array_equal, a2, small.aux))
    bad = jax.tree.map(np.copy, small.params)
    bad['E']['FC8_mu']['w'] = bad['E']['FC8_mu']['w'][:, :2]
    with pytest.raises(ValueError, match='FC8_mu'):
        bridge.load_jax_params(Networks(small.cfg, gf_dim=8), bad, small.aux)


def test_generators_match_jax(small):
    z = np.random.RandomState(2).randn(3, small.nets.gen_input_dim).astype(
        np.float32)
    refs = small.jnets.generate(small.params, small.aux, jnp.asarray(z))
    with torch.no_grad():  # the weights are trainable parameters
        gots = small.nets.generate(torch.from_numpy(z))
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), atol=2e-4)


def test_encoder_matches_jax(small):
    x, _ = small.inputs(3)
    left = _left(small, x)
    key = jax.random.PRNGKey(5)
    z, mu, ls = small._encode(left, key)
    eps = (np.asarray(z) - np.asarray(mu)) / np.exp(np.asarray(ls))
    with torch.no_grad():
        got = small.nets.encode(torch.from_numpy(left).permute(0, 3, 1, 2),
                                torch.tensor(float(np.mean(eps))))
    for g, r in zip(got, (z, mu, ls)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4)


def _check_forward(pair, batch, separate_z, atol, seed=3):
    x, classes = pair.inputs(batch)
    rng = jax.random.PRNGKey(seed)
    j_fwd = j_make_test_forward(pair.jnets, pair.jcfg, separate_z)
    ref = j_fwd(pair.params, pair.aux, jnp.asarray(x), jnp.asarray(classes),
                rng)
    eps = pair.jax_eps(_left(pair, x), rng)
    fwd = make_test_forward(pair.nets, pair.cfg, separate_z)
    with torch.inference_mode():
        got = fwd(torch.from_numpy(x), torch.from_numpy(classes), eps=eps)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)
    return got


@pytest.mark.parametrize('separate_z', [True, False])
def test_forward_matches_jax_small(small, separate_z):
    edge, image = _check_forward(small, 3, separate_z, atol=2e-4)
    assert not torch.equal(edge, image)


def test_forward_matches_jax_full_width():
    """The default serving model: 64x128 pairs, gf_dim 64, 14 classes."""
    _check_forward(Pair(FULL, gf_dim=64), 2, True, atol=3e-4)


def test_forward_bf16_matches_jax_small(small):
    """bfloat16 forward, as served: weights, images and every op in
    bfloat16. bfloat16 keeps 8 bits (relative rounding 2^-9 per op), and
    the two frameworks round at other places: cuDNN/oneDNN and XLA
    accumulate convolutions differently, and K1's plain version normalises
    in float32 where the JAX CPU path normalises in bfloat16. Over ~12
    layers that gives about 1e-3 on average and up to about 1e-2 on the
    tanh outputs in [-1, 1]; the limits leave a factor of five."""
    x, classes = small.inputs(3)
    rng = jax.random.PRNGKey(4)
    j_fwd = j_make_test_forward(small.jnets, small.jcfg)
    ref = j_fwd(small.params, small.aux, jnp.asarray(x, jnp.bfloat16),
                jnp.asarray(classes), rng)
    eps = small.jax_eps(_left(small, x), rng)
    fwd = make_test_forward(small.nets.cast(torch.bfloat16), small.cfg)
    with torch.inference_mode():
        got = fwd(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(classes), eps=eps)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        diff = np.abs(g.float().numpy() - np.asarray(r, np.float32))
        assert diff.max() < 5e-2 and diff.mean() < 5e-3, (diff.max(),
                                                          diff.mean())
