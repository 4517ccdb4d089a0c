"""Hand-written CUDA kernels of the port, each beside its plain version.

K1, `instance_norm_act`: fused instance norm + activation, forward.
  - Replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:
    105-114 (`_fwd_kernel`) and 152-160 (`instance_norm_act`).
  - Bound on an H100: bytes, 2*B*C*H*W*itemsize over 3.35 TB/s. At the
    serving shapes (at most 2 MB a call) launch latency, not bandwidth,
    sets its time.
K2, `instance_norm_act_bwd`: K1's first-order VJP from x alone.
  - Replaces `_bwd_kernel` (l.117-135), launched by `_in_bwd` (l.167-172).
  - Bound: bytes, 3*B*C*H*W*itemsize (reads x and g, writes dx).

Both live in edgegan_torch/csrc/instance_norm_act.cu, one thread block
per contiguous NCHW (batch, channel) plane, with float32 statistics. They
run in the generators' three DeconvBlocks: K1 6 times per served batch and
21 times per training step, K2 12 times per training step.

`instance_norm_act` is one `torch.autograd.Function`: its forward runs K1
and saves only x, as the JAX package's `_in_fwd` (l.163-164) does; its
backward runs K2 and is first-order only, like the JAX custom VJP. The
critics, which WGAN-GP differentiates twice, never call it.

A wrapper takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-5
_ACTS = {None: 0, 'relu': 1, 'lrelu': 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches per kernel, counted where the kernel is launched and nowhere
# else. Callers reset an entry to 0 to count one run.
LAUNCHES = {'instance_norm_act': 0, 'instance_norm_act_bwd': 0}


def _check_act(activation: Optional[str]) -> int:
    if activation not in _ACTS:
        raise ValueError(f'unknown activation {activation!r}')
    return _ACTS[activation]


def _wide(x):
    """x in float32, or in float64 when it is float64 (the tests check the
    formulas in float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _stats(x):
    """float32 (centred x, s, d) per plane: s = sqrt(var) (1 where
    var == 0), d = s + 1e-5 (1e-5 where var == 0)."""
    x32 = _wide(x)
    xc = x32 - x32.mean(dim=(2, 3), keepdim=True)
    var = (xc * xc).mean(dim=(2, 3), keepdim=True)
    nondeg = var > 0
    s = torch.sqrt(torch.where(nondeg, var, torch.ones_like(var)))
    return xc, s, torch.where(nondeg, s + EPS, torch.full_like(var, EPS))


def instance_norm_act_plain(x, activation: Optional[str] = None):
    """K1's function in plain torch: per (b, c) plane of NCHW `x`, f32
    mean and population variance, `act((x-mean)/(sqrt(var)+1e-5))` with
    denominator 1e-5 where var == 0; output in the input dtype. lrelu is
    written as `where(y > 0, y, 0.2y)`: the values of `max(y, 0.2y)`,
    with the derivative K2 takes at y == 0 (that of y < 0)."""
    _check_act(activation)
    xc, _, d = _stats(x)
    y = xc / d
    if activation == 'relu':
        y = torch.relu(y)
    elif activation == 'lrelu':
        y = torch.where(y > 0, y, 0.2 * y)
    return y.to(x.dtype)


def instance_norm_act_bwd_plain(x, g, activation: Optional[str] = None):
    """K2's function in plain torch: dx of K1 at x for the cotangent g,
    `(g' - mean g')/d - y_pre * mean(g' * y_pre)/s` per plane, with
    g' = act'(y_pre) * g; dx in x's dtype."""
    _check_act(activation)
    xc, s, d = _stats(x)
    y = xc / d
    g32 = _wide(g)
    if activation == 'relu':
        g32 = torch.where(y > 0, g32, torch.zeros_like(g32))
    elif activation == 'lrelu':
        g32 = torch.where(y > 0, g32, 0.2 * g32)
    g_mean = g32.mean(dim=(2, 3), keepdim=True)
    gy_mean = (g32 * y).mean(dim=(2, 3), keepdim=True)
    return ((g32 - g_mean) / d - y * gy_mean / s).to(x.dtype)


def _check_cuda(x, name: str):
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f'{name} takes a contiguous NCHW tensor, got '
                         f'shape {tuple(x.shape)} strides {x.stride()}')
    if x.dtype not in _DTYPES:
        raise ValueError(f'{name}: unsupported dtype {x.dtype}')


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _forward(x, activation: Optional[str]):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    act = _check_act(activation)
    if x.device.type == 'cpu':
        return instance_norm_act_plain(x, activation)
    _check_cuda(x, 'instance_norm_act')
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from ._build import library
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.edgegan_instance_norm_act_fwd(
            x.data_ptr(), y.data_ptr(), b * c, h * w, _DTYPES[x.dtype], act,
            stream)
    _raise_on(err, 'instance_norm_act')
    LAUNCHES['instance_norm_act'] += 1
    return y


def instance_norm_act_bwd(x, g, activation: Optional[str] = None):
    """K2: dx of `instance_norm_act(x, activation)` for the cotangent g.

    CPU tensors take `instance_norm_act_bwd_plain`. CUDA tensors must be
    contiguous 4-D float32 or bfloat16, g of x's shape, dtype and device;
    anything else raises."""
    act = _check_act(activation)
    if x.device.type == 'cpu' and g.device.type == 'cpu':
        return instance_norm_act_bwd_plain(x, g, activation)
    _check_cuda(x, 'instance_norm_act_bwd')
    _check_cuda(g, 'instance_norm_act_bwd')
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f'instance_norm_act_bwd: g {tuple(g.shape)} '
                         f'{g.dtype} {g.device} does not match x '
                         f'{tuple(x.shape)} {x.dtype} {x.device}')
    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    from ._build import library
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.edgegan_instance_norm_act_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), b * c, h * w,
            _DTYPES[x.dtype], act, stream)
    _raise_on(err, 'instance_norm_act_bwd')
    LAUNCHES['instance_norm_act_bwd'] += 1
    return dx


class _InstanceNormAct(torch.autograd.Function):
    """K1 forward, K2 backward; saves only x (pallas_kernels.py:163-172)."""

    @staticmethod
    def forward(ctx, x, activation):
        ctx.activation = activation
        ctx.save_for_backward(x)
        return _forward(x, activation)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return instance_norm_act_bwd(x, g.contiguous(), ctx.activation), None


def instance_norm_act(x, activation: Optional[str] = None):
    """Fused instance norm + activation of NCHW `x` (K1, backward K2).

    CPU tensors take the plain versions, forward and backward. CUDA
    tensors must be contiguous 4-D float32 or bfloat16; anything else
    raises. The backward is first-order only."""
    _check_act(activation)
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'instance_norm_act: unsupported device {x.device}')
    return _InstanceNormAct.apply(x, activation)
