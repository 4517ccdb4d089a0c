"""Discriminator, convnet variant (reference models/discriminator.py:
58-81; the JAX package's models/discriminator.py:20-46).

Four stride-2 4x4 conv blocks (nf -> 8nf, bias-free, lrelu, instance norm
on blocks 1-3) -> flatten in NHWC order -> linear(1). Returns
(sigmoid(d), d); the WGAN losses read the logits (quirk Q6).

The blocks never take the fused kernels (`allow_kernel=False`): WGAN-GP
differentiates through the critics twice and K2 is first-order only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import ConvBlock, Linear


class Discriminator(nn.Module):
    def __init__(self, in_hw: Tuple[int, int], num_filters: int = 64,
                 norm: Optional[str] = 'instance', activation: str = 'lrelu',
                 use_resnet: bool = False, in_ch: int = 3):
        super().__init__()
        if use_resnet:
            raise NotImplementedError(
                'the resnet critic (--if_resnet_d) is not ported yet')
        nf = num_filters
        blocks = [('d_conv_0', in_ch, nf, None), ('d_conv_1', nf, nf * 2, norm),
                  ('d_conv_3', nf * 2, nf * 4, norm),
                  ('d_conv_4', nf * 4, nf * 8, norm)]
        h, w = in_hw
        for name, cin, cout, n in blocks:
            setattr(self, name, ConvBlock(cin, cout, 4, 2, n, activation,
                                          allow_kernel=False))
            h, w = -(-h // 2), -(-w // 2)
        self.block_names = [b[0] for b in blocks]
        self.d_linear_5 = Linear(nf * 8 * h * w, 1)

    def forward(self, x):
        d = x
        for name in self.block_names:
            d = getattr(self, name)(d)
        d = self.d_linear_5(d.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return 1.0 / (1.0 + torch.exp(-d)), d
