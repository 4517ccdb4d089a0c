"""The port's model variants against the JAX package: the resnet generator
(`if_resnet_g`), the resnet critics (`if_resnet_d`), the convnet encoder
(`if_resnet_e=False`) and batch norm inside G's, D's and E's blocks
(`{G,D,E}_norm='batch'`), on the same weights (carried by
`bridge.load_jax_params`) and the same numpy inputs, at a small size
(critics and generators 8 filters wide, batch 2 to 4): each network's
forward, the resnet critic's first- and second-order gradients, and the
convnet encoder's route through K1/K2. One bundle of weights per
configuration is shared by the module's tests. The step, the bridge's
round trip and the entry points with the variants are in
tests/test_torch_hires.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu import losses as JL
from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.models import Encoder as JEncoder
from edgegan_tpu.train import Networks as JNetworks
from edgegan_torch import bridge
from edgegan_torch import losses as L
from edgegan_torch.core.config import Config
from edgegan_torch.ops import kernels, norms
from edgegan_torch.ops.pool import upsample_nearest
from edgegan_torch.train.networks import Networks
from test_torch_critics import _assert_grads_close, _nchw

SMALL = dict(batch_size=2, num_classes=3, z_dim=8, output_height=32,
             output_width=64, input_height=32, input_width=64,
             image_dis_size=32, edge_dis_size=32)
# every architecture flag away from its default
RESNET = dict(if_resnet_g=True, if_resnet_d=True, if_resnet_e=False)
WIDTH = dict(gf_dim=8, df_dim=8)
FWD_ATOL = 2e-4
GRAD_REL = 1e-4


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and a thread per core in each would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norms(norm):
    return dict(G_norm=norm, D_norm=norm, E_norm=norm)


def _perturbed(tree, rng):
    """`tree` with every bias, gamma and beta moved off its initial value
    (0 or 1), so that each one reaches the outputs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ('b', 'bias', 'biases') or k.endswith(('_gamma', '_beta')):
            out[k] = (v + 0.3 * rng.standard_normal(v.shape)).astype(
                np.float32)
        else:
            out[k] = v
    return out


class Bundle:
    """The small configuration with the architecture flags `arch` and
    `norm` in every block, in both packages: weights drawn by
    `bridge.random_jax_params` (whose trees are JAX's,
    tests/test_torch_hires.py `test_bridge_round_trip_nests_batch_stats`),
    biases, gammas and betas moved, loaded into the port's seven
    networks."""

    def __init__(self, norm, arch):
        kw = dict(**SMALL, **arch, **_norms(norm))
        self.cfg = Config(**kw).derive('train')
        self.jnets = JNetworks(JConfig(**kw).derive('train'), **WIDTH)
        params, self.aux = bridge.random_jax_params(self.cfg, 1,
                                                    critics=True, **WIDTH)
        self.params = _perturbed(params, np.random.default_rng(2))
        self.nets = bridge.load_jax_params(
            Networks(self.cfg, critics=True, **WIDTH), self.params, self.aux)


@pytest.fixture(scope='module')
def bundles():
    """RESNET with each norm, and the default blocks with batch norm."""
    return {'instance': Bundle('instance', RESNET),
            'batch': Bundle('batch', RESNET),
            'batch, default blocks': Bundle('batch', {})}


def _uniform(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _per_channel_generator(g, z):
    """The resnet generator with `g_norm_0` taken per channel after the
    reshape (over batch, height and width, the convnet variant's order)
    instead of per flat feature before it: the same shapes and weights,
    other numbers. NCHW output."""
    x = g.g_lin_resnet_0(z)
    gamma = g._project(g.g_norm_0.gamma[None])
    beta = g._project(g.g_norm_0.beta[None])
    x = g._project(x)
    y, _, _ = norms.batch_norm(x, torch.ones(x.shape[1]),
                               torch.zeros(x.shape[1]))
    x = torch.relu(y * gamma + beta)
    for name in g.blocks:
        x = upsample_nearest(getattr(g, name)(x))
    return torch.tanh(x)


@pytest.mark.parametrize('norm', ['instance', 'batch'])
@pytest.mark.parametrize('net', ['generator', 'critic', 'encoder'])
def test_variant_forward_matches_jax(bundles, net, norm):
    """Each variant's forward at batch 4 within FWD_ATOL of JAX's in
    float32. The
    resnet generator's `g_norm_0` normalises each of the projection's
    8*gf*h/16*w/16 flat features over the batch, before the reshape; a
    per-channel norm after it gives outputs that JAX's are far from."""
    b = bundles[norm]
    with torch.no_grad():
        if net == 'generator':
            assert b.nets.G1.g_norm_0.gamma.shape == (8 * 8 * 2 * 2,)
            z = _uniform(3, 4, b.nets.gen_input_dim)
            ref = np.asarray(b.jnets.generate(b.params, b.aux,
                                              jnp.asarray(z))[0])
            got = b.nets.G1(torch.from_numpy(z)).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got.numpy(), ref, atol=FWD_ATOL)
            other = _per_channel_generator(b.nets.G1, torch.from_numpy(z))
            assert np.abs(other.permute(0, 2, 3, 1).numpy() - ref).max() \
                > 100 * FWD_ATOL
        elif net == 'critic':
            for name, w in (('D', 64), ('D_patch2', 32)):
                x = _uniform(4, 4, 32, w, 3)
                ref = b.jnets.discriminate(name, b.params, b.aux,
                                           jnp.asarray(x))
                got = b.nets.discriminate(name, _nchw(x))
                for g, r in zip(got, ref):
                    np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                               atol=FWD_ATOL)
        else:
            x = _uniform(5, 4, 32, 32, 3)
            jz, jmu, jls = (np.asarray(a, np.float64) for a in b.jnets.encode(
                b.params, b.aux, jnp.asarray(x), jax.random.PRNGKey(6)))
            i = np.unravel_index(np.argmax(np.abs(jz - jmu)), jz.shape)
            eps = torch.tensor((jz[i] - jmu[i]) / np.exp(jls[i]),
                               dtype=torch.float32)
            got = b.nets.encode(_nchw(x), eps)
            for g, r in zip(got, (jz, jmu, jls)):
                np.testing.assert_allclose(g.numpy(), r, atol=FWD_ATOL)


def test_batch_norm_in_default_blocks_matches_jax(bundles):
    """Batch norm inside the default architectures' blocks (the convnet
    generator's DeconvBlocks, the convnet critic's ConvBlocks, the resnet
    encoder's Residual blocks, each owning `norm` or `norm1`/`norm2`) at
    batch 4: each forward within FWD_ATOL of JAX's."""
    b = bundles['batch, default blocks']
    z = _uniform(11, 4, b.nets.gen_input_dim)
    pair, half = _uniform(12, 4, 32, 64, 3), _uniform(13, 4, 32, 32, 3)
    with torch.no_grad():
        for got, ref in zip(
                b.nets.generate(torch.from_numpy(z)),
                b.jnets.generate(b.params, b.aux, jnp.asarray(z))):
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(ref), atol=FWD_ATOL)
        for got, ref in zip(b.nets.discriminate('D', _nchw(pair)),
                            b.jnets.discriminate('D', b.params, b.aux,
                                                 jnp.asarray(pair))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=FWD_ATOL)
        mu, log_sigma = b.nets.E.heads(_nchw(half))
    _, jmu, jls = b.jnets.encode(b.params, b.aux, jnp.asarray(half),
                                 jax.random.PRNGKey(0))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=FWD_ATOL)
    np.testing.assert_allclose(log_sigma.numpy(), np.asarray(jls),
                               atol=FWD_ATOL)


@pytest.mark.parametrize('norm', ['instance', 'batch'])
def test_resnet_critic_gradients_match_jax(bundles, norm):
    """The resnet critic's input gradient of sum(sigmoid) + sum(logit)
    (what the penalty differentiates, quirk Q4), and the gradient of WGAN
    + penalty with respect to its weights, which differentiates it twice,
    through `Residual2`'s lrelus and, with batch norm, through statistics
    that couple the rows (the gradient of the batch sum, not a per-sample
    one): within GRAD_REL of the largest entry."""
    b = bundles[norm]
    name = 'D'
    fake, real = _uniform(7, 2, 32, 64, 3), _uniform(8, 2, 32, 64, 3)
    key = jax.random.PRNGKey(9)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))

    def jd(p, x):
        return b.jnets.discriminate(name, {**b.params, name: p}, b.aux, x)

    jdx = np.asarray(jax.grad(lambda x: sum(
        jnp.sum(o) for o in jd(b.params[name], x)))(jnp.asarray(fake)))
    x = _nchw(fake).requires_grad_(True)
    dx, = torch.autograd.grad(sum(o.sum() for o in b.nets.discriminate(
        name, x)), x)
    dx = dx.permute(0, 2, 3, 1).numpy()
    assert np.abs(dx - jdx).max() <= GRAD_REL * np.abs(jdx).max()

    def jloss(p):
        _, real_logit = jd(p, jnp.asarray(real))
        _, fake_logit = jd(p, jnp.asarray(fake))
        gp = JL.gradient_penalty(lambda t: jd(p, t), jnp.asarray(fake),
                                 jnp.asarray(real), key, 10.0)
        return JL.discriminator_ganloss(fake_logit, real_logit) + gp

    jv, jgrads = jax.jit(jax.value_and_grad(jloss))(b.params[name])

    def d(t):
        return b.nets.discriminate(name, t)
    _, real_logit = d(_nchw(real))
    _, fake_logit = d(_nchw(fake))
    loss = L.discriminator_ganloss(fake_logit, real_logit) + \
        L.gradient_penalty(d, _nchw(fake), _nchw(real),
                           torch.from_numpy(alpha.reshape(2).copy()), 10.0)
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    paths = bridge.param_paths(b.nets)
    named = list(b.nets.D.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    tgrads = {}
    for (n, _), g in zip(named, grads):
        path, kind = paths[f'D.{n}']
        tgrads[path[1:]] = bridge.to_jax_layout(g, kind, path[-1])
    _assert_grads_close(jgrads, tgrads, GRAD_REL)


def test_convnet_encoder_takes_k1_k2_and_zeros_one_element_planes(
        monkeypatch):
    """The convnet encoder at a 64x64 sketch: its six normed blocks call
    K1's dispatch forward and K2's backward (spies), on contiguous NCHW
    tensors also when the sketch is a permuted NHWC view, as the test CLI
    and the server pass it (a convolution of it returns channels-last
    strides, which the kernels refuse); every block's output matches
    JAX's within FWD_ATOL, and the last two blocks' 1x1 planes (variance
    0) are exactly 0 in both, so mu and log_sigma are the FC8 biases."""
    cfg = Config(num_classes=3, z_dim=8, input_height=64,
                 if_resnet_e=False).derive('test')
    params, aux = bridge.random_jax_params(cfg, 3, gf_dim=8)
    params['E'] = _perturbed(params['E'], np.random.default_rng(4))
    nets = bridge.load_jax_params(Networks(cfg, gf_dim=8), params, aux)
    x = _uniform(10, 2, 64, 64, 3)
    (_, jmu, _), inter = JEncoder(latent_dim=8, image_size=64,
                                  use_resnet=False).apply(
        {'params': params['E']}, jnp.asarray(x),
        rngs={'noise': jax.random.PRNGKey(0)}, capture_intermediates=True,
        mutable=['intermediates'])
    jblocks = {k: np.asarray(v['__call__'][0])
               for k, v in inter['intermediates'].items()
               if k.startswith('e_convnet')}
    calls = []
    for fn in ('_forward', 'instance_norm_act_bwd'):
        real = getattr(kernels, fn)
        monkeypatch.setattr(kernels, fn, lambda *a, _f=real, _n=fn: (
            calls.append(_n if a[0].is_contiguous() else 'strided'),
            _f(*a))[1])
    e = nets.E
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    outs = {}
    for name in e.trunk:
        h = getattr(e, name)(h)
        outs[name] = h
    assert calls == ['_forward'] * 6
    assert set(outs) == set(jblocks) and len(outs) == 7
    for name, t in outs.items():
        np.testing.assert_allclose(t.detach().permute(0, 2, 3, 1).numpy(),
                                   jblocks[name], atol=FWD_ATOL, err_msg=name)
    for name in e.trunk[-2:]:
        assert outs[name].shape[2:] == (1, 1)
        assert not outs[name].any() and not jblocks[name].any()
    mu, _ = e.heads(_nchw(x))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu),
                               atol=FWD_ATOL)
    np.testing.assert_array_equal(
        mu.detach().numpy(), np.broadcast_to(params['E']['FC8_mu']['b'],
                                             mu.shape))
    calls.clear()
    torch.autograd.grad(e.heads(_nchw(x))[0].sum(),
                        [e.e_convnet_128_1.conv2d.w])
    assert calls == ['_forward'] * 6 + ['instance_norm_act_bwd'] * 6
