"""Building blocks as `nn.Module`s, NCHW (reference nn/modules, cited per
class).

Submodule and parameter names are the JAX package's (`conv2d/w`,
`deconv2d/b`, `Matrix`, `g_norm_0_gamma`, ...), so `bridge.py` maps the
two trees by name; only the layouts differ (see `ops/conv.py`). Weights
are made zero here and come in through the bridge. Each op casts its
weight to the input dtype, as the JAX package does per op.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import activations, conv as conv_ops, kernels, norms


def _param(*shape, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill), requires_grad=False)


class BatchNorm(nn.Module):
    """Train-mode batch norm (quirk Q14) with learnable gamma/beta. The
    moving statistics are carried as buffers but never read, as in the
    reference. `Networks.cast` keeps gamma/beta float32 in a bfloat16
    copy, since the JAX package reads them as float32 (ops/norms.py:94)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = _param(channels, fill=1.0)
        self.beta = _param(channels)
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x):
        out, _, _ = norms.batch_norm(x, self.gamma, self.beta)
        return out


def norm_apply(x, norm: Optional[str]):
    """Dispatch like reference normalization.py:10-29, for the parameter-
    free norms; batch norm is the `BatchNorm` module."""
    if norm is None:
        return x
    if norm == 'instance':
        return norms.instance_norm(x)
    if norm == 'batch':
        raise NotImplementedError('batch norm inside a block is not ported '
                                  'yet (only the generator projection)')
    raise ValueError(f'unknown norm: {norm!r}')


def norm_act(x, norm: Optional[str], activation: Optional[str]):
    """norm -> activation; instance norm with {None, relu, lrelu} goes to
    the fused kernel K1 (layers.py:43-56 of the JAX package), except with
    EDGEGAN_NAN_GUARDS=0, whose unguarded numerics the kernel does not
    implement (pallas_kernels.py:44-56)."""
    if (norm == 'instance' and activation in (None, 'relu', 'lrelu')
            and norms.nan_guards_enabled()):
        return kernels.instance_norm_act(x, activation)
    return activations.activation_fn(norm_apply(x, norm), activation)


class Conv2D(nn.Module):
    """conv2d (reference conv.py:13-36); JAX kernel layout [k,k,in,out]."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 2, pad: str = 'SAME', use_bias: bool = True):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.w = _param(features, in_ch, kernel_size, kernel_size)
        self.b = _param(features) if use_bias else None

    def forward(self, x):
        return conv_ops.conv2d(x, self.w, self.stride, self.pad, self.b)


class Deconv2D(nn.Module):
    """deconv2d (reference conv.py:39-58); JAX layout [k,k,out,in]."""

    def __init__(self, in_ch: int, features: int, out_hw: Tuple[int, int],
                 kernel_size: int = 5, stride: int = 2):
        super().__init__()
        self.out_hw, self.stride = tuple(out_hw), stride
        self.w = _param(in_ch, features, kernel_size, kernel_size)
        self.b = _param(features)

    def forward(self, x):
        return conv_ops.deconv2d(x, self.w, self.out_hw, self.stride, self.b)


class Linear(nn.Module):
    """linear (reference linear.py:10-31): matmul + bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Matrix = _param(features, in_features)
        self.bias = _param(features)

    def forward(self, x):
        return F.linear(x, self.Matrix.to(x.dtype), self.bias.to(x.dtype))


class Mlp(nn.Module):
    """mlp (reference linear.py:79-92): matmul + bias -> act -> norm."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None,
                 norm: Optional[str] = None):
        super().__init__()
        self.activation, self.norm = activation, norm
        self.w = _param(features, in_features)
        self.b = _param(features)

    def forward(self, x):
        out = F.linear(x, self.w.to(x.dtype), self.b.to(x.dtype))
        return norm_apply(activations.activation_fn(out, self.activation),
                          self.norm)


class ConvBlock(nn.Module):
    """conv_block (reference conv.py:61-67): conv -> norm -> act."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int, norm: Optional[str] = None,
                 activation: Optional[str] = None, pad: str = 'SAME',
                 use_bias: bool = False):
        super().__init__()
        self.norm, self.activation = norm, activation
        self.conv2d = Conv2D(in_ch, features, kernel_size, stride, pad,
                             use_bias)

    def forward(self, x):
        return norm_act(self.conv2d(x), self.norm, self.activation)


class DeconvBlock(nn.Module):
    """deconv_block (reference conv.py:124-130): deconv -> norm -> act."""

    def __init__(self, in_ch: int, features: int, out_hw: Tuple[int, int],
                 kernel_size: int, stride: int, norm: Optional[str] = None,
                 activation: Optional[str] = None):
        super().__init__()
        self.norm, self.activation = norm, activation
        self.deconv2d = Deconv2D(in_ch, features, out_hw, kernel_size,
                                 stride)

    def forward(self, x):
        return norm_act(self.deconv2d(x), self.norm, self.activation)


class Residual(nn.Module):
    """residual (reference conv.py:70-85): two 3x3 REFLECT convs + a 1x1
    shortcut, relu on the sum. Its norms take the plain path, as in the
    JAX package (layers.py:201-207)."""

    def __init__(self, in_ch: int, features: int,
                 norm: Optional[str] = 'instance', pad: str = 'REFLECT',
                 use_bias: bool = False):
        super().__init__()
        self.norm = norm
        self.res1 = Conv2D(in_ch, features, 3, 1, pad, use_bias)
        self.res2 = Conv2D(features, features, 3, 1, pad, use_bias)
        self.shortcut = Conv2D(in_ch, features, 1, 1, pad, use_bias)

    def forward(self, x):
        out = activations.relu(norm_apply(self.res1(x), self.norm))
        out = norm_apply(self.res2(out), self.norm)
        return activations.relu(self.shortcut(x) + out)
