"""Encoder (reference models/encoder.py; the JAX package's
models/encoder.py:37-82).

Maps the sketch half to z with a VAE head: (mu, log_sigma) and the
sample `z = mu + eps * exp(log_sigma)`, from the trunk's output flattened
in NHWC order.

- resnet trunk (the default, --if_resnet_e; encoder.py:54-84): a
  stride-2 conv, four (five at image_size 256) `Residual` blocks each
  followed by a 2x2 average pool, relu and an 8x8 average pool.
- convnet trunk (--noif_resnet_e; JAX l.74-82): seven (eight at
  image_size 256) stride-2 4x4 bias-free conv blocks with relu, the norm
  on every block but the first. With instance norm those six blocks take
  the fused kernels K1 (forward) and K2 (backward in the encoder's
  update). At a 64x64 input the last two blocks' planes are 1x1: their
  variance is 0, so they normalise to 0 (K1, its plain version and JAX
  alike) and `mu`/`log_sigma` are the FC8 biases alone.

Parity quirk Q2: the reference draws ONE scalar eps for the whole batch
and latent vector (`tf.random_normal(shape=tf.shape(<python int>))` has
shape []), so `forward` takes eps as a 0-d tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import activations
from ..ops.pool import tf_avg_pool
from .layers import ConvBlock, Mlp, Residual


def reparameterize(mu, log_sigma, eps):
    """z = mu + eps * exp(log_sigma), eps a 0-d tensor cast to mu's dtype
    first, as the JAX package does (encoder.py:45)."""
    return mu + eps.to(mu.dtype) * torch.exp(log_sigma)


class Encoder(nn.Module):
    def __init__(self, latent_dim: int = 100, image_size: int = 64,
                 norm: Optional[str] = 'instance', activation: str = 'relu',
                 use_resnet: bool = True, in_ch: int = 3):
        super().__init__()
        self.use_resnet = use_resnet
        self.trunk = []
        if use_resnet:
            num_filters = [128, 256, 512, 512]
            if image_size == 256:
                num_filters.append(512)
            self.e_resnet_64_0 = ConvBlock(in_ch, 64, 4, 2, None, activation,
                                           use_bias=True)
            prev = 64
            for i, n in enumerate(num_filters):
                name = f'e_resnet_{n}_{i + 1}'
                setattr(self, name, Residual(prev, n, norm, use_bias=True))
                self.trunk.append(name)
                prev = n
            out_hw = 1   # 1/2, four 2x2 pools, then an 8x8 pool
        else:
            num_filters = [64, 128, 256, 512, 512, 512, 512]
            if image_size == 256:
                num_filters.append(512)
            prev, out_hw = in_ch, image_size
            for i, n in enumerate(num_filters):
                name = f'e_convnet_{n}_{i}'
                setattr(self, name, ConvBlock(prev, n, 4, 2,
                                              norm if i else None,
                                              activation))
                self.trunk.append(name)
                prev, out_hw = n, -(-out_hw // 2)
        self.FC8_mu = Mlp(prev * out_hw * out_hw, latent_dim)
        self.FC8_sigma = Mlp(prev * out_hw * out_hw, latent_dim)

    def heads(self, x):
        """NCHW sketch -> (mu, log_sigma)."""
        if self.use_resnet:
            e = self.e_resnet_64_0(x)
            for name in self.trunk:
                e = tf_avg_pool(getattr(self, name)(e), 2, 2)
            e = tf_avg_pool(activations.relu(e), 8, 8)
        else:
            e = x
            for name in self.trunk:
                e = getattr(self, name)(e)
        e = e.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.FC8_mu(e), self.FC8_sigma(e)

    def forward(self, x, eps):
        mu, log_sigma = self.heads(x)
        return reparameterize(mu, log_sigma, eps), mu, log_sigma
