"""Hand-written CUDA kernels of the port, each beside its plain version.

K1, `instance_norm_act`: fused instance norm + activation, forward.
  - Replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:
    105-114 (`_fwd_kernel`) and 152-160 (`instance_norm_act`).
  - Kernel: edgegan_torch/csrc/instance_norm_act.cu, one thread block per
    contiguous NCHW (batch, channel) plane, f32 statistics.
  - Bound on an H100: bytes, 2*B*C*H*W*itemsize over 3.35 TB/s. At the
    serving shapes (at most 2 MB a call) launch latency, not bandwidth,
    sets its time.
  - Runs in the generators' three DeconvBlocks, so 6 launches per served
    batch (G1 and G2). Its backward (K2) is not ported yet.

A wrapper takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-5
_ACTS = {None: 0, 'relu': 1, 'lrelu': 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches per kernel, counted where the kernel is launched and nowhere
# else. Callers reset an entry to 0 to count one run.
LAUNCHES = {'instance_norm_act': 0}


def _check_act(activation: Optional[str]) -> int:
    if activation not in _ACTS:
        raise ValueError(f'unknown activation {activation!r}')
    return _ACTS[activation]


def instance_norm_act_plain(x, activation: Optional[str] = None):
    """K1's function in plain torch: per (b, c) plane of NCHW `x`, f32
    mean and population variance, `act((x-mean)/(sqrt(var)+1e-5))` with
    denominator 1e-5 where var == 0; output in the input dtype."""
    _check_act(activation)
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=(2, 3), keepdim=True)
    nondeg = var > 0
    denom = torch.where(
        nondeg, torch.sqrt(torch.where(nondeg, var, torch.ones_like(var)))
        + EPS, torch.full_like(var, EPS))
    y = xc / denom
    if activation == 'relu':
        y = torch.relu(y)
    elif activation == 'lrelu':
        y = torch.maximum(y, 0.2 * y)
    return y.to(x.dtype)


def instance_norm_act(x, activation: Optional[str] = None):
    """Fused instance norm + activation of NCHW `x` (K1).

    CPU tensors take `instance_norm_act_plain`. CUDA tensors must be
    contiguous 4-D float32 or bfloat16 and must not require grad (the
    backward, K2, is not ported); anything else raises.
    """
    act = _check_act(activation)
    if x.device.type == 'cpu':
        return instance_norm_act_plain(x, activation)
    if x.requires_grad:
        raise NotImplementedError(
            'instance_norm_act has no backward on CUDA yet: its VJP kernel '
            '(K2, pallas_kernels._bwd_kernel) is not ported')
    if x.device.type != 'cuda':
        raise ValueError(f'instance_norm_act: unsupported device {x.device}')
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError('instance_norm_act takes a contiguous NCHW tensor, '
                         f'got shape {tuple(x.shape)} strides {x.stride()}')
    if x.dtype not in _DTYPES:
        raise ValueError(f'instance_norm_act: unsupported dtype {x.dtype}')
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
    if err != 0:
        raise RuntimeError(f'instance_norm_act launch failed: CUDA error '
                           f'{err}')
    LAUNCHES['instance_norm_act'] += 1
    return y
