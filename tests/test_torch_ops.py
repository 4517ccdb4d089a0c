"""The port's ops (edgegan_torch.ops, NCHW) against the JAX package's
(edgegan_tpu.ops, NHWC) on the same numpy inputs, atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegan_tpu.ops import activations as jact
from edgegan_tpu.ops import conv as jconv
from edgegan_tpu.ops import norms as jnorms
from edgegan_tpu.ops import pool as jpool
from edgegan_tpu.ops.resize import resize as jresize
from edgegan_torch.ops import activations as tact
from edgegan_torch.ops import conv as tconv
from edgegan_torch.ops import norms as tnorms
from edgegan_torch.ops import pool as tpool
from edgegan_torch.ops.resize import resize as tresize
from test_torch_variants import few_threads  # noqa: F401

ATOL = 1e-4


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1,
                                                                  2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('shape,k,stride,pad', [
    ((2, 9, 7, 3), 4, 1, 'SAME'),
    ((2, 9, 7, 3), 5, 2, 'SAME'),
    ((2, 8, 8, 5), 4, 2, 'SAME'),
    ((2, 6, 6, 4), 3, 1, 'REFLECT'),
    ((2, 6, 6, 4), 1, 1, 'REFLECT'),
])
def test_conv2d(shape, k, stride, pad):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(k, k, shape[-1], 6).astype(np.float32)  # HWIO
    ref = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride,
                                  pad))
    got = tconv.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                       stride, pad)
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


@pytest.mark.parametrize('in_hw,out_hw,k,stride', [
    ((4, 4), (8, 8), 5, 2),
    ((3, 5), (5, 9), 5, 2),
    ((6, 6), (6, 6), 1, 1),
])
def test_deconv2d(in_hw, out_hw, k, stride):
    rng = np.random.RandomState(1)
    x = rng.randn(2, *in_hw, 6).astype(np.float32)
    w = rng.randn(k, k, 10, 6).astype(np.float32)  # [k,k,out,in]
    b = rng.randn(10).astype(np.float32)
    ref = np.asarray(jconv.deconv2d(jnp.asarray(x), jnp.asarray(w), out_hw,
                                    stride)) + b
    got = tconv.deconv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                         out_hw, stride, torch.from_numpy(b))
    assert got.is_contiguous()
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


@pytest.mark.parametrize('case', ['f32', 'bf16', 'degenerate', 'unguarded'])
def test_instance_norm(case, monkeypatch):
    if case == 'unguarded':
        monkeypatch.setenv('EDGEGAN_NAN_GUARDS', '0')
    x = np.random.RandomState(2).randn(2, 8, 4, 4).astype(np.float32) * 3
    if case == 'degenerate':
        # a constant plane; H*W a power of two keeps the mean exact in
        # both frameworks, so var is exactly 0
        x[1, :, :, 2] = 0.75
    if case == 'bf16':
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = _nchw(x).to(torch.bfloat16)
        # bfloat16 keeps 8 bits: one rounding of the normalised value
        # (|y| <= ~3) differs between the frameworks by at most 2^-6
        atol = 2 ** -5
    else:
        xj, xt, atol = jnp.asarray(x), _nchw(x), ATOL
    ref = np.asarray(jnorms.instance_norm(xj).astype(jnp.float32))
    got = _nhwc(tnorms.instance_norm(xt))
    np.testing.assert_allclose(got, ref, atol=atol)
    if case == 'degenerate':
        assert np.all(got[1, :, :, 2] == 0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batch_norm(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 4, 5).astype(np.float32)
    gamma = rng.randn(5).astype(np.float32)
    beta = rng.randn(5).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref, rmean, rvar = jnorms.batch_norm(jnp.asarray(x, jdt),
                                         jnp.asarray(gamma),
                                         jnp.asarray(beta))
    got, mean, var = tnorms.batch_norm(_nchw(x).to(tdt),
                                       torch.from_numpy(gamma),
                                       torch.from_numpy(beta))
    assert got.dtype == tdt
    atol = ATOL if dtype == 'float32' else 2 ** -4  # one bf16 rounding
    np.testing.assert_allclose(_nhwc(got),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), atol=ATOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(rvar), atol=ATOL)


@pytest.mark.parametrize('hw,window,stride', [
    ((8, 6), 2, 2), ((7, 5), 2, 2), ((2, 2), 8, 8), ((5, 3), 8, 8)])
def test_tf_avg_pool(hw, window, stride):
    x = np.random.RandomState(4).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(jpool.tf_avg_pool(jnp.asarray(x), window, stride))
    got = _nhwc(tpool.tf_avg_pool(_nchw(x), window, stride))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize('name', [None, 'relu', 'lrelu', 'tanh'])
def test_activations(name):
    x = np.random.RandomState(5).randn(4, 7).astype(np.float32)
    ref = np.asarray(jact.activation_fn(jnp.asarray(x), name))
    got = tact.activation_fn(torch.from_numpy(x), name).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize('in_hw,out_hw', [
    ((64, 64), (128, 128)),   # the train step's crops ahead of the critics
    ((32, 32), (32, 32)),     # equal sizes: no resize
    ((6, 10), (9, 4)),        # up in H, down in W
])
def test_resize(in_hw, out_hw):
    """TF1-legacy bicubic (no half-pixel offset, A = -0.75, clamped taps)
    as two matmuls with the JAX package's matrices."""
    x = np.random.RandomState(6).randn(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(x), out_hw))
    got = _nhwc(tresize(_nchw(x), out_hw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    bf = tresize(_nchw(x).to(torch.bfloat16), out_hw)
    assert bf.dtype == torch.bfloat16


def test_mean_pool():
    x = np.random.RandomState(7).randn(2, 8, 6, 3).astype(np.float32)
    ref = np.asarray(jpool.mean_pool(jnp.asarray(x)))
    got = _nhwc(tpool.mean_pool(_nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    with pytest.raises(ValueError, match='even'):
        tpool.mean_pool(_nchw(x[:, :7]))


@pytest.mark.parametrize('kind', ['conv', 'dense'])
def test_spectral_normalize(kind):
    """One power iteration from a frozen u: w_bar and u_new, and the
    gradient of a loss of w_bar, which flows through sigma and through the
    iteration (quirk Q3 keeps u; JAX differentiates all of it)."""
    rng = np.random.RandomState(8)
    shape = (3, 3, 5, 7) if kind == 'conv' else (6, 7)   # JAX layouts
    perm = (3, 2, 0, 1) if kind == 'conv' else (1, 0)    # -> the port's
    inv = tuple(int(i) for i in np.argsort(perm))
    w = rng.randn(*shape).astype(np.float32) * 0.1
    u = rng.randn(1, 7).astype(np.float32)
    c = rng.randn(*shape).astype(np.float32)

    def jloss(w_):
        w_bar, _ = jnorms.spectral_normalize(w_, jnp.asarray(u))
        return jnp.sum(w_bar * c)

    jw_bar, ju = jnorms.spectral_normalize(jnp.asarray(w), jnp.asarray(u))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(w)))
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))
    tw.requires_grad_(True)
    w_bar, u_new = tnorms.spectral_normalize(tw, torch.from_numpy(u))
    loss = torch.sum(w_bar * torch.from_numpy(
        np.ascontiguousarray(c.transpose(perm))))
    tgrad, = torch.autograd.grad(loss, tw)
    np.testing.assert_allclose(w_bar.detach().numpy().transpose(inv),
                               np.asarray(jw_bar), atol=1e-6)
    np.testing.assert_allclose(u_new.detach().numpy(), np.asarray(ju),
                               atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy().transpose(inv), jgrad,
                               atol=1e-5)


def test_prelu_tie_splits_like_jax():
    """PReLU is max(leak*x, x): at x == 0 both branches tie, and
    torch.maximum splits the cotangent 0.5/0.5 between them as
    jnp.maximum does, for x and for the leak."""
    x = np.array([-1.5, 0.0, 0.0, 2.0], np.float32)
    g = np.array([1.0, 1.0, -2.0, 0.5], np.float32)
    _, vjp = jax.vjp(jact.prelu, jnp.asarray(x), jnp.float32(0.2))
    jdx, jdleak = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    leak = torch.tensor(0.2, requires_grad=True)
    dx, dleak = torch.autograd.grad(tact.prelu(tx, leak), (tx, leak),
                                    torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-7)
    np.testing.assert_allclose(dx.numpy()[1:3], 0.6 * g[1:3], atol=1e-7)
    np.testing.assert_allclose(float(dleak), float(jdleak), atol=1e-6)


@pytest.mark.parametrize('op', ['tf_avg_pool', 'resize'])
def test_cached_constants_survive_inference_mode(op):
    """The per-shape divisor and resize matrices are cached per device.
    One first made while serving (under `torch.inference_mode`) must still
    be usable by training in the same process, which saves it for the
    backward."""
    def run(x):
        if op == 'tf_avg_pool':
            return tpool.tf_avg_pool(x, 2, 2)
        return tresize(x, (13, 9))

    shape = (1, 2, 11, 7)  # shapes no other test caches
    with torch.inference_mode():
        run(torch.randn(shape))
    x = torch.randn(shape, requires_grad=True)
    g, = torch.autograd.grad(run(x).sum(), x)
    assert torch.isfinite(g).all()
