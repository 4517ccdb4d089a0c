"""Generator (reference models/generator.py; the JAX package's
models/generator.py). Takes z [B, D], returns NCHW [B, output_dim, H, W].

- convnet (generator.py:35-74, the default): z -> linear projection ->
  reshape to (h/16, w/16, 8*input_dim) -> per-channel norm -> four
  stride-2 5x5 transposed-conv blocks -> tanh.
- resnet (`use_resnet`, generator.py:76-120; JAX l.71-88): z -> linear
  projection -> norm over its 8*input_dim*h/16*w/16 flat features ->
  reshape -> four stride-1 3x3 `Deresidual2` blocks, each followed by a
  2x nearest upsample -> tanh.

Parity quirk Q14: the reference's first norm call binds the norm name to
`is_train` and so always runs train-mode BATCH norm, whatever --G_norm
says. The other rows of a batch therefore change each row's output. In
the resnet variant it runs before the reshape, so each of the flat
features is a channel of its own.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import activations
from ..ops.pool import upsample_nearest
from .layers import BatchNorm, DeconvBlock, Deresidual2, Linear


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
        sizes = _size_chain(output_height, output_width)
        d = input_dim
        self.activation, self.use_resnet = activation, use_resnet
        self.proj_hw = sizes[4]
        self.proj_ch = d * 8
        flat = d * 8 * sizes[4][0] * sizes[4][1]
        chans = [d * 8, d * 4, d * 2, d, output_dim]
        if use_resnet:
            self.g_lin_resnet_0 = Linear(z_dim, flat)
            self.g_norm_0 = BatchNorm(flat)
            self.blocks = [f'g_resnet_{i}' for i in range(1, 5)]
            (h, w) = self.proj_hw
            for i, name in enumerate(self.blocks, 1):
                last = i == 4
                # stride 1 at the incoming size, which each upsample doubles
                setattr(self, name, Deresidual2(
                    chans[i - 1], chans[i], (h, w), 3, 1,
                    None if last else norm, None if last else activation))
                h, w = 2 * h, 2 * w
        else:
            self.g_lin_0 = Linear(z_dim, flat)
            self.g_norm_0 = BatchNorm(d * 8)
            self.blocks = [f'g_dconv_{i}' for i in range(1, 5)]
            for i, name in enumerate(self.blocks, 1):
                last = i == 4
                setattr(self, name, DeconvBlock(
                    chans[i - 1], chans[i], sizes[4 - i], 5, 2,
                    None if last else norm, None if last else activation))

    def _project(self, x):
        # the JAX package reshapes NHWC (B, h/16, w/16, 8d); go to NCHW after
        return x.view(-1, *self.proj_hw, self.proj_ch).permute(0, 3, 1, 2)

    def forward(self, z):
        if self.use_resnet:
            x = self.g_norm_0(self.g_lin_resnet_0(z))
            x = self._project(activations.activation_fn(x, self.activation))
            for name in self.blocks:
                x = upsample_nearest(getattr(self, name)(x))
        else:
            x = self.g_norm_0(self._project(self.g_lin_0(z)))
            x = activations.activation_fn(x, self.activation)
            for name in self.blocks:
                x = getattr(self, name)(x)
        return torch.tanh(x)
