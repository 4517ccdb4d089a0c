"""K1 (`instance_norm_act`): the port's plain version against the Pallas
kernel in interpret mode, the CPU/CUDA dispatch of its wrapper, and the
port's independence of JAX.

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


def test_non_cpu_wrapper_refuses_before_launch():
    """Off the CPU the wrapper never takes the plain version: a tensor
    that requires grad is refused naming K2, and a device it has no
    kernel for raises (meta tensors stand in for a device here)."""
    x = torch.empty(2, 3, 4, 4, device='meta', requires_grad=True)
    with pytest.raises(NotImplementedError, match='K2'):
        kernels.instance_norm_act(x, 'relu')
    with pytest.raises(ValueError, match='device'):
        kernels.instance_norm_act(x.detach(), 'relu')


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
    x = torch.randn(2, 3, 4, 4, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match='K2'):
        kernels.instance_norm_act(x, 'relu')
    with pytest.raises(ValueError, match='contiguous'):
        kernels.instance_norm_act(x.detach().transpose(2, 3), 'relu')
    with pytest.raises(ValueError, match='dtype'):
        kernels.instance_norm_act(x.detach().half(), 'relu')


def test_port_imports_no_jax():
    """Every module of edgegan_torch, and chip_smoke.py, import without
    JAX or the JAX package (checked in a fresh interpreter)."""
    code = (
        'import importlib, pkgutil, runpy, sys\n'
        'import edgegan_torch\n'
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
