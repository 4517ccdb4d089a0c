"""Building blocks as `nn.Module`s, NCHW (reference nn/modules, cited per
class).

Submodule and parameter names are the JAX package's (`conv2d/w`,
`deconv2d/b`, `Matrix`, `g_norm_0_gamma`, `weights`, `prelu/param`, ...),
so `bridge.py` maps the two trees by name; only the layouts differ (see
`ops/conv.py`). Weights are made zero here and come in through the bridge.
Every weight is a trainable parameter; serving runs under
`torch.inference_mode()`, so it keeps no autograd state. The spectral-norm
vectors `u` are float32 buffers (the JAX package's `spectral` collection).
They stay frozen (quirk Q3) unless the training step's `update_sn` calls
`advance_spectral_norms`. Each op casts its weight to the input dtype, as
the JAX package does per op.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import activations, conv as conv_ops, kernels, norms
from ..ops.pool import mean_pool


def _param(*shape, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill))


class BatchNorm(nn.Module):
    """Train-mode batch norm (quirk Q14) with learnable gamma/beta, over
    the channels of NCHW or the features of a 2-D [B, F]. The moving
    statistics are carried as buffers but never read, and training
    leaves them as they are, since the JAX step keeps `batch_stats`
    immutable (layers.py:74-84). `Networks.cast` keeps gamma/beta float32
    in a bfloat16 copy, since the JAX package reads them as float32
    (ops/norms.py:94).

    A block with `norm='batch'` owns one under the JAX package's name
    (`norm`, or `norm1`/`norm2` in the residual blocks), so its weights
    are `<block>/norm_gamma`, ... there (`_norm_apply`, layers.py:59-85).
    """

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = _param(channels, fill=1.0)
        self.beta = _param(channels)
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x):
        out, _, _ = norms.batch_norm(x, self.gamma, self.beta)
        return out


def batch_norm_for(norm: Optional[str], channels: int):
    """The `BatchNorm` a block owns for `norm`: one for 'batch', None for
    the parameter-free norms; an unknown norm raises."""
    if norm not in (None, 'instance', 'batch'):
        raise ValueError(f'unknown norm: {norm!r}')
    return BatchNorm(channels) if norm == 'batch' else None


def norm_apply(x, norm: Optional[str], bn: Optional[BatchNorm] = None):
    """Dispatch like reference normalization.py:10-29; `bn` is the
    block's `BatchNorm` for norm 'batch'."""
    if norm is None:
        return x
    if norm == 'instance':
        return norms.instance_norm(x)
    if norm == 'batch':
        return bn(x)
    raise ValueError(f'unknown norm: {norm!r}')


def norm_act(x, norm: Optional[str], activation: Optional[str],
             allow_kernel: bool = True, bn: Optional[BatchNorm] = None):
    """norm -> activation; instance norm with {None, relu, lrelu} goes to
    the fused kernels K1/K2 (layers.py:43-56 of the JAX package), except
    with EDGEGAN_NAN_GUARDS=0, whose unguarded numerics the kernels do not
    implement (pallas_kernels.py:44-56), and where the caller passes
    `allow_kernel=False`: the critics, which WGAN-GP differentiates twice
    while K2 is first-order only. Batch norm takes the plain path. The
    kernels take contiguous NCHW: a convolution of a permuted NHWC view
    (the test CLI's and the server's sketch half, into the convnet
    encoder) returns channels-last strides, made contiguous here."""
    if (allow_kernel and norm == 'instance'
            and activation in (None, 'relu', 'lrelu')
            and norms.nan_guards_enabled()):
        return kernels.instance_norm_act(x.contiguous(), activation)
    return activations.activation_fn(norm_apply(x, norm, bn), activation)


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
        self.activation, self.norm_kind = activation, norm
        self.w = _param(features, in_features)
        self.b = _param(features)
        self.norm = batch_norm_for(norm, features)

    def forward(self, x):
        out = F.linear(x, self.w.to(x.dtype), self.b.to(x.dtype))
        return norm_apply(activations.activation_fn(out, self.activation),
                          self.norm_kind, self.norm)


class ConvBlock(nn.Module):
    """conv_block (reference conv.py:61-67): conv -> norm -> act.
    `allow_kernel` is the JAX package's `allow_pallas`."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int, norm: Optional[str] = None,
                 activation: Optional[str] = None, pad: str = 'SAME',
                 use_bias: bool = False, allow_kernel: bool = True):
        super().__init__()
        self.norm_kind, self.activation = norm, activation
        self.allow_kernel = allow_kernel
        self.conv2d = Conv2D(in_ch, features, kernel_size, stride, pad,
                             use_bias)
        self.norm = batch_norm_for(norm, features)

    def forward(self, x):
        return norm_act(self.conv2d(x), self.norm_kind, self.activation,
                        self.allow_kernel, self.norm)


class DeconvBlock(nn.Module):
    """deconv_block (reference conv.py:124-130): deconv -> norm -> act."""

    def __init__(self, in_ch: int, features: int, out_hw: Tuple[int, int],
                 kernel_size: int, stride: int, norm: Optional[str] = None,
                 activation: Optional[str] = None):
        super().__init__()
        self.norm_kind, self.activation = norm, activation
        self.deconv2d = Deconv2D(in_ch, features, out_hw, kernel_size,
                                 stride)
        self.norm = batch_norm_for(norm, features)

    def forward(self, x):
        return norm_act(self.deconv2d(x), self.norm_kind, self.activation,
                        bn=self.norm)


class Residual(nn.Module):
    """residual (reference conv.py:70-85): two 3x3 REFLECT convs + a 1x1
    shortcut, relu on the sum. Its norms take the plain path, as in the
    JAX package (layers.py:201-207)."""

    def __init__(self, in_ch: int, features: int,
                 norm: Optional[str] = 'instance', pad: str = 'REFLECT',
                 use_bias: bool = False):
        super().__init__()
        self.norm_kind = norm
        self.res1 = Conv2D(in_ch, features, 3, 1, pad, use_bias)
        self.norm1 = batch_norm_for(norm, features)
        self.res2 = Conv2D(features, features, 3, 1, pad, use_bias)
        self.norm2 = batch_norm_for(norm, features)
        self.shortcut = Conv2D(in_ch, features, 1, 1, pad, use_bias)

    def forward(self, x):
        out = norm_apply(self.res1(x), self.norm_kind, self.norm1)
        out = norm_apply(self.res2(activations.relu(out)), self.norm_kind,
                         self.norm2)
        return activations.relu(self.shortcut(x) + out)


class Residual2(nn.Module):
    """residual2 (reference conv.py:88-103; the JAX package's
    layers.py:213-234), the resnet critic's block: two convs with lrelu
    between them + a 1x1 shortcut, `activation` on the sum. Its norms
    take the plain path: the critics are differentiated twice."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int, norm: Optional[str] = None,
                 activation: Optional[str] = 'lrelu', pad: str = 'SAME',
                 use_bias: bool = False):
        super().__init__()
        self.norm_kind, self.activation = norm, activation
        self.res1 = Conv2D(in_ch, features, kernel_size, stride, pad,
                           use_bias)
        self.norm1 = batch_norm_for(norm, features)
        self.res2 = Conv2D(features, features, kernel_size, stride, pad,
                           use_bias)
        self.norm2 = batch_norm_for(norm, features)
        self.shortcut = Conv2D(in_ch, features, 1, 1, pad, use_bias)

    def forward(self, x):
        out = norm_apply(self.res1(x), self.norm_kind, self.norm1)
        out = self.res2(activations.activation_fn(out, 'lrelu'))
        out = norm_apply(out, self.norm_kind, self.norm2)
        return activations.activation_fn(self.shortcut(x) + out,
                                         self.activation)


class Deresidual2(nn.Module):
    """deresidual2 (reference conv.py:106-121; the JAX package's
    layers.py:237-256), the resnet generator's block: two transposed
    convs with `activation` between them + a 1x1 transposed-conv
    shortcut, `activation` on the sum. Its norms take the plain path, as
    in the JAX package (never K1/K2)."""

    def __init__(self, in_ch: int, features: int, out_hw: Tuple[int, int],
                 kernel_size: int, stride: int, norm: Optional[str] = None,
                 activation: Optional[str] = None):
        super().__init__()
        self.norm_kind, self.activation = norm, activation
        self.res1 = Deconv2D(in_ch, features, out_hw, kernel_size, stride)
        self.norm1 = batch_norm_for(norm, features)
        self.res2 = Deconv2D(features, features, out_hw, kernel_size, stride)
        self.norm2 = batch_norm_for(norm, features)
        self.shortcut = Deconv2D(in_ch, features, out_hw, 1, 1)

    def forward(self, x):
        out = norm_apply(self.res1(x), self.norm_kind, self.norm1)
        out = self.res2(activations.activation_fn(out, self.activation))
        out = norm_apply(out, self.norm_kind, self.norm2)
        return activations.activation_fn(self.shortcut(x) + out,
                                         self.activation)


class PReLU(nn.Module):
    """prelu (reference activation.py:23-27): a learnable scalar leak,
    float32, initialised to 0.2. With `kernels.prelu_enabled()` the
    backward is the fused kernel K5, which takes the float32 leak, as the
    JAX package's switched path does (layers.py:273-277); otherwise the
    plain autograd of `max(leak*x, x)`. Both split the tie at x == 0
    evenly."""

    def __init__(self):
        super().__init__()
        self.param = _param(fill=0.2)

    def forward(self, x):
        if kernels.prelu_enabled():
            return kernels.prelu(x, self.param)
        return activations.prelu(x, self.param.to(x.dtype))


class SNConv2D(nn.Module):
    """conv2d2 (reference conv.py:246-295): stride-1 SAME conv with
    spectral norm, bias and an activation in {None, relu, lrelu, prelu}.
    Weights OIHW; `u` [1, out] is a buffer (the `spectral` collection)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 activation: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.weights = _param(features, in_ch, kernel_size, kernel_size)
        self.register_buffer('u', torch.zeros(1, features))
        self.biases = _param(features)
        if activation == 'prelu':
            self.prelu = PReLU()

    def forward(self, x):
        w, _ = norms.spectral_normalize(self.weights, self.u)
        out = conv_ops.conv2d(x, w, 1, 'SAME', self.biases)
        if self.activation == 'prelu':
            return self.prelu(out)
        return activations.activation_fn(out, self.activation)


class SNDense(nn.Module):
    """fully_connected (reference linear.py:34-77): spectral-normed dense
    layer. Weights [out, in]; `u` [1, out] is a buffer."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weights = _param(features, in_features)
        self.register_buffer('u', torch.zeros(1, features))
        self.biases = _param(features)

    def forward(self, x):
        w, _ = norms.spectral_normalize(self.weights, self.u)
        return F.linear(x, w.to(x.dtype), self.biases.to(x.dtype))


@torch.no_grad()
def advance_spectral_norms(module: nn.Module):
    """One power iteration for every spectral-norm layer in `module`:
    `u <- u_new` of `spectral_normalize(weights, u)`, the JAX package's
    `update_sn` (layers.py:294-345). u_new depends on the layer's weight
    and its `u` only, not on the input, so no forward is needed: this is
    what JAX's `classifier.apply(..., mutable=['spectral'])` leaves in the
    collection, for every layer it reaches (`disc_head` included). `u`
    stays float32 under bfloat16, as JAX computes it from the float32
    parameter."""
    for m in module.modules():
        if isinstance(m, (SNConv2D, SNDense)):
            m.u.copy_(norms.spectral_normalize(m.weights, m.u)[1])


class MRUBlock(nn.Module):
    """mru_conv_block_v3 (reference conv.py:133-243), the classifier's
    stride-2 unit: a min-max-normalised update gate blends an input conv
    into the hidden state, two 3x3 convs make the new hidden state, added
    to a 1x1-projected residual (every unit of the classifier changes the
    depth), then a 2x2 mean pool.

    With `kernels.gate_enabled()` the min-max gate and blend are the
    fused kernels K3 (forward) and K4 (backward), as in the JAX package's
    switched path (layers.py:386-392). Otherwise, its default path
    (l.393-406): `amin`/`amax`, whose backward splits tied extrema evenly
    as `jnp.min`/`jnp.max` do (`max(dim)` does not), in the input dtype.
    Both guard a spatially constant gate to a zero gate; the plain path
    drops the guard under EDGEGAN_NAN_GUARDS=0, which also turns the
    kernels off.
    """

    def __init__(self, in_ch: int, hidden_depth: int, filter_depth: int):
        super().__init__()
        self.norm_activation_in_prelu = PReLU()
        self.update_gate = SNConv2D(hidden_depth + in_ch, hidden_depth, 3,
                                    activation='lrelu')
        self.img_conv = SNConv2D(in_ch, hidden_depth, 3)
        self.norm_activation_merge_1_prelu = PReLU()
        self.h_conv1 = SNConv2D(hidden_depth, filter_depth, 3,
                                activation='prelu')
        self.h_conv2 = SNConv2D(filter_depth, filter_depth, 3)
        self.shortcut = SNConv2D(hidden_depth, filter_depth, 1)

    def forward(self, inp, ht):
        full_inp = torch.cat([self.norm_activation_in_prelu(ht), inp], dim=1)
        rg = self.update_gate(full_inp)
        img_new = self.img_conv(inp)
        if kernels.gate_enabled():
            ht_plus = kernels.mru_gate(rg, ht, img_new)
        else:
            rg_min = rg.amin(dim=(2, 3), keepdim=True)
            rg_range = rg.amax(dim=(2, 3), keepdim=True) - rg_min
            if norms.nan_guards_enabled():
                rg_range = torch.where(rg_range > 0, rg_range,
                                       torch.ones_like(rg_range))
            ht_plus = ht + (rg - rg_min) / rg_range * img_new
        h_new = self.h_conv1(self.norm_activation_merge_1_prelu(ht_plus))
        h_new = self.h_conv2(h_new)
        return mean_pool(self.shortcut(ht) + h_new)
