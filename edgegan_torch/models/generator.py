"""Generator, convnet variant (reference models/generator.py:35-74).

z -> linear projection -> reshape to (h/16, w/16, 8*input_dim) -> four
stride-2 5x5 transposed-conv blocks -> tanh. Takes z [B, D], returns
NCHW [B, output_dim, H, W].

Parity quirk Q14: the reference's first norm call binds the norm name to
`is_train` and so always runs train-mode BATCH norm, whatever --G_norm
says. The other rows of a batch therefore change each row's output.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import activations
from .layers import BatchNorm, DeconvBlock, Linear


def _size_chain(h: int, w: int, steps: int = 4):
    sizes = [(h, w)]
    for _ in range(steps):
        h = int(math.ceil(h / 2))
        w = int(math.ceil(w / 2))
        sizes.append((h, w))
    return sizes  # [(h,w), (h/2,w/2), ..., (h/16,w/16)]


class Generator(nn.Module):
    def __init__(self, z_dim: int, output_height: int = 64,
                 output_width: int = 64, input_dim: int = 64,
                 output_dim: int = 3, norm: Optional[str] = 'instance',
                 activation: str = 'relu', use_resnet: bool = False):
        super().__init__()
        if use_resnet:
            raise NotImplementedError(
                'the resnet generator (Deresidual2) is not ported yet')
        sizes = _size_chain(output_height, output_width)
        d = input_dim
        self.activation = activation
        self.proj_hw = sizes[4]
        self.proj_ch = d * 8
        self.g_lin_0 = Linear(z_dim, d * 8 * sizes[4][0] * sizes[4][1])
        self.g_norm_0 = BatchNorm(d * 8)
        chans = [d * 8, d * 4, d * 2, d, output_dim]
        for i in range(1, 5):
            last = i == 4
            setattr(self, f'g_dconv_{i}', DeconvBlock(
                chans[i - 1], chans[i], sizes[4 - i], 5, 2,
                None if last else norm, None if last else activation))

    def forward(self, z):
        x = self.g_lin_0(z)
        # the JAX package reshapes NHWC (B, h/16, w/16, 8d); go to NCHW after
        x = x.view(-1, *self.proj_hw, self.proj_ch).permute(0, 3, 1, 2)
        x = activations.activation_fn(self.g_norm_0(x), self.activation)
        for i in range(1, 5):
            x = getattr(self, f'g_dconv_{i}')(x)
        return torch.tanh(x)
