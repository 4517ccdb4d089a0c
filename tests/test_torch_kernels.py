"""K1 (`instance_norm_act`) and K2 (`instance_norm_act_bwd`): the port's
plain versions against the Pallas kernels in interpret mode (K2 through
`jax.vjp` of the custom VJP), the autograd Function that joins them, the
CPU/CUDA dispatch of the wrappers, and the port's independence of JAX.

Tests marked `cuda` need the card; they skip without one and run on it
with `python -m pytest --noconftest -m cuda tests/test_torch_kernels.py`.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from edgegan_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTS = [None, 'relu', 'lrelu']


def _x(shape=(2, 8, 4, 6), seed=0):
    """NHWC numpy input, with one constant plane (var == 0)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2
    x[1, :, :, 3] = 0.5
    return x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('act', ACTS)
def test_plain_matches_pallas_interpret(act):
    jnp = pytest.importorskip('jax.numpy')
    from edgegan_tpu.ops import pallas_kernels as pk
    x = _x()
    ref = np.asarray(pk.instance_norm_act(jnp.asarray(x), act, True))
    got = kernels.instance_norm_act_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), act)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


def test_cpu_wrapper_is_plain_and_uncounted():
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2)
    before = kernels.LAUNCHES['instance_norm_act']
    for act in ACTS:
        assert torch.equal(kernels.instance_norm_act(x, act),
                           kernels.instance_norm_act_plain(x, act))
    bf = x.to(torch.bfloat16)
    out = kernels.instance_norm_act(bf, 'relu')
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, kernels.instance_norm_act_plain(bf, 'relu'))
    assert kernels.LAUNCHES['instance_norm_act'] == before
    with pytest.raises(ValueError):
        kernels.instance_norm_act(x, 'tanh')


@pytest.mark.parametrize('act', ACTS)
def test_bwd_plain_matches_pallas_vjp(act):
    """K2's plain version against `jax.vjp` of the Pallas custom VJP in
    interpret mode (its `_bwd_kernel`), constant plane included."""
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from edgegan_tpu.ops import pallas_kernels as pk
    x = _x()
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: pk.instance_norm_act(t, act, True),
                     jnp.asarray(x))
    ref, = vjp(jnp.asarray(g))
    got = kernels.instance_norm_act_bwd_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(g).permute(0, 3, 1, 2), act)
    # atol 1e-5 on the normal planes; on the constant plane dx is
    # (g' - mean g')/1e-5, values up to ~1e5 whose float32 spacing is
    # ~1e-2, so there the limit is relative (measured 3.9e-7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize('act', ACTS)
def test_bwd_plain_is_autograd_of_plain_forward(act):
    """K2's formula is the derivative of K1's plain version, constant
    plane included (both take the activation's slope at 0 from below)."""
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2).double()
    x.requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        *x.shape)).double()
    ref, = torch.autograd.grad(kernels.instance_norm_act_plain(x, act), x, g)
    got = kernels.instance_norm_act_bwd_plain(x.detach(), g, act)
    torch.testing.assert_close(got, ref, atol=1e-9, rtol=1e-9)


def test_function_on_cpu_is_plain_forward_and_backward():
    """On the CPU the autograd Function runs both plain versions: its
    value and gradient equal autograd of `instance_norm_act_plain`, it is
    first-order only, and no launch is counted."""
    before = dict(kernels.LAUNCHES)
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2).requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(3).randn(*x.shape)).float()
    for act in ACTS:
        y = kernels.instance_norm_act(x, act)
        dx, = torch.autograd.grad(y, x, g)
        ref = kernels.instance_norm_act_plain(x, act)
        dref, = torch.autograd.grad(ref, x, g)
        assert torch.equal(y, ref)
        torch.testing.assert_close(dx, dref, atol=1e-5, rtol=1e-5)
    y = kernels.instance_norm_act(x, 'relu')
    dx, = torch.autograd.grad(y, x, g.requires_grad_(True), create_graph=True)
    with pytest.raises(RuntimeError, match='once_differentiable'):
        dx.sum().backward()
    assert kernels.LAUNCHES == before


def test_non_cpu_wrapper_refuses_before_launch():
    """Off the CPU the wrappers never take the plain versions: a device
    they have no kernel for raises, whether or not the tensor requires
    grad (meta tensors stand in for a device here), and nothing is
    counted as launched."""
    before = dict(kernels.LAUNCHES)
    x = torch.empty(2, 3, 4, 4, device='meta', requires_grad=True)
    for t in (x, x.detach()):
        with pytest.raises(ValueError, match='device'):
            kernels.instance_norm_act(t, 'relu')
    with pytest.raises(ValueError, match='device'):
        kernels.instance_norm_act_bwd(x.detach(), torch.empty_like(x),
                                      'relu')
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ACTS)
def test_kernel_matches_plain_on_card(cuda, dtype, act):
    x = torch.from_numpy(_x((16, 32, 32, 64))).permute(0, 3, 1, 2)
    x = x.contiguous().to(cuda, dtype)
    before = kernels.LAUNCHES['instance_norm_act']
    got = kernels.instance_norm_act(x, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['instance_norm_act'] == before + 1
    ref = kernels.instance_norm_act_plain(x, act)
    tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_kernel_refuses_on_card(cuda):
    """On the card the wrappers launch or raise: a strided or float16
    input and a cotangent that does not match x are refused."""
    x = torch.randn(2, 3, 4, 4, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.instance_norm_act(x.transpose(2, 3), 'relu')
    with pytest.raises(ValueError, match='dtype'):
        kernels.instance_norm_act(x.half(), 'relu')
    with pytest.raises(ValueError, match='does not match'):
        kernels.instance_norm_act_bwd(x, x[:1].contiguous(), 'relu')
    with pytest.raises(ValueError, match='contiguous'):
        kernels.instance_norm_act_bwd(x, x.transpose(2, 3), 'relu')


def _gated_close(got, ref, x, act, **tol):
    """assert_close, leaving out the elements whose y_pre lies within 1e-4
    of 0 when there is an activation: there the rounding of the plane's
    mean decides relu's or lrelu's slope, differently in the kernel and in
    the plain version."""
    if act is not None:
        band = kernels.instance_norm_act_plain(x.detach(), None).float()
        keep = band.abs() >= 1e-4
        got, ref = got.float()[keep], ref.float()[keep]
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ACTS)
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, act):
    x = torch.from_numpy(_x((16, 32, 32, 64))).permute(0, 3, 1, 2)
    x = x.contiguous().to(cuda, dtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    g = g.to(cuda, dtype)
    before = kernels.LAUNCHES['instance_norm_act_bwd']
    got = kernels.instance_norm_act_bwd(x, g, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['instance_norm_act_bwd'] == before + 1
    ref = kernels.instance_norm_act_bwd_plain(x, g, act)
    # dx divides by d = sqrt(var) + 1e-5, and by 1e-5 on the constant plane
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    _gated_close(got, ref, x, act, **tol)


@pytest.mark.cuda
def test_function_gradient_on_card(cuda):
    """The Function's backward (K2) against autograd of the plain forward,
    with both kernels counted once."""
    x = torch.from_numpy(_x((4, 16, 16, 32))).permute(0, 3, 1, 2)
    x = x.contiguous().to(cuda).requires_grad_(True)
    g = torch.randn(x.shape, device=cuda)
    before = dict(kernels.LAUNCHES)
    dx, = torch.autograd.grad(kernels.instance_norm_act(x, 'relu'), x, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['instance_norm_act'] == before[
        'instance_norm_act'] + 1
    assert kernels.LAUNCHES['instance_norm_act_bwd'] == before[
        'instance_norm_act_bwd'] + 1
    ref, = torch.autograd.grad(kernels.instance_norm_act_plain(x, 'relu'),
                               x, g)
    _gated_close(dx, ref, x, 'relu', atol=1e-4, rtol=1e-4)


def test_port_imports_no_jax():
    """Every module of edgegan_torch, the training path's named first,
    and chip_smoke.py, import without JAX or the JAX package (checked in
    a fresh interpreter)."""
    code = (
        'import importlib, pkgutil, runpy, sys\n'
        'import edgegan_torch\n'
        "for name in ('cli.train', 'train.step', 'checkpoint', "
        "'data.dataset', 'data.loader', 'losses'):\n"
        "    importlib.import_module('edgegan_torch.' + name)\n"
        'for m in pkgutil.walk_packages(edgegan_torch.__path__, '
        "'edgegan_torch.'):\n"
        '    importlib.import_module(m.name)\n'
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'edgegan_tpu', "
        "'edgegan'))\n"
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
