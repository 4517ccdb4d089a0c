"""The port's critics, classifier, losses, gradient penalty and TF1
RMSProp against the JAX package, on the same weights (drawn by
`bridge.random_jax_params`), inputs and blend weights."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgegan_tpu import losses as JL
from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.train.networks import Networks as JNetworks
from edgegan_torch import bridge
from edgegan_torch import losses as L
from edgegan_torch.core.config import Config
from edgegan_torch.models.discriminator import Discriminator
from edgegan_torch.ops import kernels
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import RMSProp

SMALL = dict(batch_size=2, num_classes=3, z_dim=8, output_height=32,
             output_width=64, input_height=32, input_width=64,
             image_dis_size=32, edge_dis_size=32)
CRITICS = ['D', 'D_patch2', 'D_patch3']


class Pair:
    """The small training configuration in both packages, shared weights
    (critics 8 filters wide, the classifier at its only width)."""

    def __init__(self, seed=0):
        self.cfg = Config(**SMALL).derive('train')
        self.jnets = JNetworks(JConfig(**SMALL).derive('train'), gf_dim=8,
                               df_dim=8)
        self.params, self.aux = bridge.random_jax_params(
            self.cfg, seed, gf_dim=8, critics=True, df_dim=8)
        self.nets = bridge.load_jax_params(
            Networks(self.cfg, gf_dim=8, df_dim=8, critics=True),
            self.params, self.aux)

    def inputs(self, name, seed=1):
        """(fake, real) NHWC numpy inputs of critic `name`."""
        w = 64 if name == 'D' else 32
        rng = np.random.RandomState(seed)
        return tuple(rng.uniform(-1, 1, (2, 32, w, 3)).astype(np.float32)
                     for _ in range(2))

    def port_grads(self, name, loss):
        """{JAX param path: gradient in the JAX layout} of `loss` with
        respect to network `name`'s parameters."""
        paths = bridge.param_paths(self.nets)
        named = list(getattr(self.nets, name).named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        out = {}
        for (n, p), g in zip(named, grads):
            path, kind = paths[f'{name}.{n}']
            g = torch.zeros_like(p) if g is None else g
            out[path[1:]] = bridge.to_jax_layout(g, kind, path[-1])
        return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_grads_close(jgrads, tgrads, rel):
    """Same keys; the gradient vectors within `rel` relative L2 distance,
    and every entry within `rel` of the largest entry."""
    j = _flat(jgrads)
    assert set(j) == set(tgrads)
    a = np.concatenate([j[k].ravel() for k in sorted(j)])
    b = np.concatenate([tgrads[k].ravel() for k in sorted(j)])
    scale = np.abs(a).max()
    assert scale > 0
    assert np.linalg.norm(a - b) <= rel * np.linalg.norm(a), (
        np.linalg.norm(a - b) / np.linalg.norm(a))
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


@pytest.fixture(scope='module')
def pair():
    return Pair()


def test_random_params_have_the_jax_layout_with_critics(pair):
    """random_jax_params draws exactly the trees Networks.init makes
    (names, shapes, dtypes) for all seven networks, spectral `u`s and
    PReLU leaks included."""
    params, aux = jax.eval_shape(pair.jnets.init, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda s: (s.shape, s.dtype), (params, aux))
    got = jax.tree.map(lambda a: (a.shape, a.dtype), (pair.params, pair.aux))
    assert got == want


@pytest.mark.parametrize('name', CRITICS)
def test_critic_matches_jax(pair, name):
    fake, _ = pair.inputs(name)
    ref = pair.jnets.discriminate(name, pair.params, pair.aux,
                                  jnp.asarray(fake))
    with torch.no_grad():
        got = pair.nets.discriminate(name, _nchw(fake))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4)


def test_classifier_matches_jax(pair):
    x = np.random.RandomState(2).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    ref = jax.jit(pair.jnets.classify)(pair.params, pair.aux,
                                       jnp.asarray(x))
    with torch.no_grad():
        got = pair.nets.classify(_nchw(x))
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref[0]), atol=3e-4)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-4)


@pytest.mark.parametrize('name', CRITICS)
def test_critic_loss_and_penalty_match_jax(pair, name):
    """The critic group's loss, WGAN plus the gradient penalty on the
    blend with the same alpha (quirk Q4: the penalty differentiates
    sum(sigmoid) + sum(logit)), and its gradient with respect to the
    critic's weights, which differentiates the critic twice. The
    gradients agree within 2e-3 relative: the second derivative runs
    through lrelu's kink and instance norms of 2x2 and 2x4 planes, where
    JAX's own gradient moves by 1e-3 relative when its input moves by
    1e-7 relative (measured on the full-width joint critic)."""
    fake, real = pair.inputs(name)
    key = jax.random.PRNGKey(7)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))

    def jloss(d_params):
        p = {**pair.params, name: d_params}

        def d(x):
            return pair.jnets.discriminate(name, p, pair.aux, x)
        _, real_logit = d(jnp.asarray(real))
        _, fake_logit = d(jnp.asarray(fake))
        gp = JL.gradient_penalty(d, jnp.asarray(fake), jnp.asarray(real),
                                 key, 10.0)
        return JL.discriminator_ganloss(fake_logit, real_logit), gp

    (jwgan, jgp), jvjp = jax.vjp(jax.jit(jloss), pair.params[name])
    jgrads, = jvjp((jnp.float32(1.0), jnp.float32(1.0)))

    def d(x):
        return pair.nets.discriminate(name, x)
    _, real_logit = d(_nchw(real))
    _, fake_logit = d(_nchw(fake))
    wgan = L.discriminator_ganloss(fake_logit, real_logit)
    gp = L.gradient_penalty(d, _nchw(fake), _nchw(real),
                            torch.from_numpy(alpha.reshape(2).copy()), 10.0)
    np.testing.assert_allclose(wgan.item(), float(jwgan), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gp.item(), float(jgp), rtol=1e-4)
    _assert_grads_close(jgrads, pair.port_grads(name, wgan + gp), 2e-3)


def test_classifier_loss_gradient_matches_jax(pair):
    """The classifier group: focal AC-GAN loss on the real photo half,
    and its gradient with respect to every classifier weight (the unused
    disc_head's is zero in both)."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    labels = np.array([2, 0])

    def jloss(c_params):
        p = {**pair.params, 'D2': c_params}
        _, _, logits = pair.jnets.classify(p, pair.aux, jnp.asarray(x))
        return JL.get_acgan_loss_focal(logits, jnp.asarray(labels), logits,
                                       jnp.asarray(labels), 3)[1]

    jv, jgrads = jax.jit(jax.value_and_grad(jloss))(pair.params['D2'])
    _, _, logits = pair.nets.classify(_nchw(x))
    lab = torch.from_numpy(labels)
    _, tv = L.get_acgan_loss_focal(logits, lab, logits, lab, 3)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    tgrads = pair.port_grads('D2', tv)
    assert not np.any(tgrads[('disc_head', 'weights')])
    _assert_grads_close(jgrads, tgrads, 1e-3)


def test_losses_match_jax():
    rng = np.random.RandomState(4)
    a, b = rng.randn(5, 1).astype(np.float32), rng.randn(5, 1).astype(
        np.float32)
    logits = rng.randn(5, 4).astype(np.float32)
    labels = np.array([0, 3, 1, 1, 2])
    ta, tb, tl = (torch.from_numpy(v) for v in (a, b, logits))
    tlab = torch.from_numpy(labels)
    pairs = [
        (L.discriminator_ganloss(ta, tb), JL.discriminator_ganloss(a, b)),
        (L.generator_ganloss(ta), JL.generator_ganloss(a)),
        (L.l1loss(ta, tb, 10.0), JL.l1loss(a, b, 10.0)),
    ]
    pairs += list(zip(L.get_acgan_loss_focal(tl, tlab, tl.flip(0), tlab, 4),
                      JL.get_acgan_loss_focal(logits, labels, logits[::-1],
                                              labels, 4)))
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(L._sparse_ce(tl, tlab).numpy(),
                               np.asarray(JL._sparse_ce(logits, labels)),
                               rtol=1e-6)


def test_gradient_penalty_guard_at_zero_gradient():
    """A critic whose output does not depend on its input has a zero
    gradient norm; the guarded sqrt keeps the penalty (lambda * 1) and its
    gradient finite."""
    w = torch.tensor(0.5, requires_grad=True)

    def d(x):
        out = w * torch.ones(x.shape[0], 1) + 0 * x.sum()
        return torch.sigmoid(out), out

    x = torch.zeros(2, 1, 2, 2)
    gp = L.gradient_penalty(d, x, x, torch.full((2,), 0.5), 10.0)
    g, = torch.autograd.grad(gp, w)
    assert float(gp) == 10.0 and torch.isfinite(g)


def test_rmsprop_matches_optax():
    """TF1 RMSProp (slots start at ones, eps inside the sqrt) against
    optax.rmsprop(decay=0.9, eps=1e-10, initial_scale=1.0,
    eps_in_sqrt=True) over 3 updates."""
    rng = np.random.RandomState(5)
    params = [rng.randn(3, 4).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params]
             for s in (1.0, 0.01, 30.0)]
    tx = optax.rmsprop(2e-4, decay=0.9, eps=1e-10, initial_scale=1.0,
                       eps_in_sqrt=True)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    slots = [torch.ones_like(p) for p in tp]
    opt = RMSProp(2e-4)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [torch.from_numpy(x) for x in g], slots)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7)
    for a, b in zip(slots, state[0].nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_critics_never_reach_the_fused_kernels(pair, monkeypatch):
    """The critics' instance norms take the plain path: WGAN-GP
    differentiates them twice and K2 is first-order only. A spy on the
    kernels' dispatch sees no call from a critic forward, its penalty and
    its double backward, and 3 K1 and 3 K2 calls from one generator's
    forward and backward."""
    calls = []
    fwd, bwd = kernels._forward, kernels.instance_norm_act_bwd
    monkeypatch.setattr(kernels, '_forward',
                        lambda *a: calls.append('K1') or fwd(*a))
    monkeypatch.setattr(kernels, 'instance_norm_act_bwd',
                        lambda *a: calls.append('K2') or bwd(*a))
    assert all(not isinstance(m, Discriminator) or
               all(not b.allow_kernel for b in m.children()
                   if hasattr(b, 'allow_kernel'))
               for m in pair.nets.modules())
    for name in CRITICS:
        fake, real = pair.inputs(name)

        def d(x, name=name):
            return pair.nets.discriminate(name, x)
        gp = L.gradient_penalty(d, _nchw(fake), _nchw(real),
                                torch.full((2,), 0.3), 10.0)
        torch.autograd.grad(gp, list(getattr(pair.nets, name).parameters()))
    assert calls == []
    z = torch.randn(2, pair.nets.gen_input_dim)
    out = pair.nets.G1(z)
    torch.autograd.grad(out.sum(), list(pair.nets.G1.parameters()))
    assert calls == ['K1'] * 3 + ['K2'] * 3
