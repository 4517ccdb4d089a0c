"""Encoder, resnet trunk (reference models/encoder.py:54-84).

Maps the sketch half to z with a VAE head: (mu, log_sigma) and the
sample `z = mu + eps * exp(log_sigma)`. Parity quirk Q2: the reference
draws ONE scalar eps for the whole batch and latent vector
(`tf.random_normal(shape=tf.shape(<python int>))` has shape []), so
`forward` takes eps as a 0-d tensor.
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
        if not use_resnet:
            raise NotImplementedError(
                'the convnet encoder trunk is not ported yet')
        num_filters = [128, 256, 512, 512]
        if image_size == 256:
            num_filters.append(512)
        self.e_resnet_64_0 = ConvBlock(in_ch, 64, 4, 2, None, activation,
                                       use_bias=True)
        self.trunk = []
        prev = 64
        for i, n in enumerate(num_filters):
            name = f'e_resnet_{n}_{i + 1}'
            setattr(self, name, Residual(prev, n, norm, use_bias=True))
            self.trunk.append(name)
            prev = n
        self.FC8_mu = Mlp(prev, latent_dim)
        self.FC8_sigma = Mlp(prev, latent_dim)

    def heads(self, x):
        """NCHW sketch -> (mu, log_sigma)."""
        e = self.e_resnet_64_0(x)
        for name in self.trunk:
            e = tf_avg_pool(getattr(self, name)(e), 2, 2)
        e = tf_avg_pool(activations.relu(e), 8, 8)
        e = e.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.FC8_mu(e), self.FC8_sigma(e)

    def forward(self, x, eps):
        mu, log_sigma = self.heads(x)
        return reparameterize(mu, log_sigma, eps), mu, log_sigma
