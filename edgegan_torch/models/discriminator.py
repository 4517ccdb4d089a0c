"""Discriminator (reference models/discriminator.py; the JAX package's
models/discriminator.py:20-64). Returns (sigmoid(d), d); the WGAN losses
read the logits (quirk Q6).

- convnet (the default, l.20-46): four stride-2 4x4 conv blocks (nf ->
  8nf, bias-free, lrelu, the norm on blocks 1-3) -> flatten in NHWC
  order -> linear(1).
- resnet (`use_resnet`, l.48-64): four stride-1 3x3 `Residual2` blocks
  (nf -> 8nf, the norm on blocks 1-3), each followed by a 2x2 SAME
  average pool, then the activation, an 8x8 SAME average pool, and
  linear(1) on the NHWC flatten: 64x128 -> 4x8 -> 1x1, 128x256 -> 8x16
  -> 1x2.

The blocks never take the fused kernels (`allow_kernel=False`, and
`Residual2` has no kernel route): WGAN-GP differentiates through the
critics twice and K2 is first-order only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import activations
from ..ops.pool import tf_avg_pool
from .layers import ConvBlock, Linear, Residual2

_BLOCKS = ('0', '1', '3', '4')   # the reference's scope numbers


def _halve(h: int, w: int, window: int = 2):
    return -(-h // window), -(-w // window)


class Discriminator(nn.Module):
    def __init__(self, in_hw: Tuple[int, int], num_filters: int = 64,
                 norm: Optional[str] = 'instance', activation: str = 'lrelu',
                 use_resnet: bool = False, in_ch: int = 3):
        super().__init__()
        nf = num_filters
        self.activation, self.use_resnet = activation, use_resnet
        chans = [in_ch, nf, nf * 2, nf * 4, nf * 8]
        h, w = in_hw
        self.block_names = []
        for i, n in enumerate(_BLOCKS):
            block_norm = norm if i else None
            if use_resnet:
                name = f'd_resnet_{n}'
                block = Residual2(chans[i], chans[i + 1], 3, 1, block_norm,
                                  activation)
            else:
                name = f'd_conv_{n}'
                block = ConvBlock(chans[i], chans[i + 1], 4, 2, block_norm,
                                  activation, allow_kernel=False)
            setattr(self, name, block)
            self.block_names.append(name)
            h, w = _halve(h, w)   # the stride-2 conv or the 2x2 pool
        if use_resnet:
            h, w = _halve(h, w, 8)
            self.d_linear_resnet_5 = Linear(nf * 8 * h * w, 1)
        else:
            self.d_linear_5 = Linear(nf * 8 * h * w, 1)

    def forward(self, x):
        d = x
        for name in self.block_names:
            d = getattr(self, name)(d)
            if self.use_resnet:
                d = tf_avg_pool(d, 2, 2)
        if self.use_resnet:
            d = tf_avg_pool(activations.activation_fn(d, self.activation),
                            8, 8)
            linear = self.d_linear_resnet_5
        else:
            linear = self.d_linear_5
        d = linear(d.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return 1.0 / (1.0 + torch.exp(-d)), d
