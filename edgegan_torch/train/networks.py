"""Network bundle: the G1/G2/E subset of the JAX package's `Networks`
(train/networks.py:27-142), the part that inference and serving run.

Submodule names are the reference's variable scopes ('G1', 'G2', 'E'),
so `bridge.py` maps the JAX parameter trees onto them by name. The
critics and the classifier come with the training slice.
"""
from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import Config
from ..models.encoder import Encoder
from ..models.generator import Generator
from ..models.layers import BatchNorm


class Networks(nn.Module):
    def __init__(self, config: Config, gf_dim: int = 64, c_dim: int = 3):
        super().__init__()
        self.config = config
        self.z_dim = config.z_dim
        half_w = int(config.output_width / 2)
        gen = dict(z_dim=self.gen_input_dim,
                   output_height=config.output_height, output_width=half_w,
                   input_dim=gf_dim, output_dim=c_dim, norm=config.G_norm,
                   use_resnet=config.if_resnet_g)
        self.G1 = Generator(**gen)   # edge generator
        self.G2 = Generator(**gen)   # image generator
        self.E = Encoder(latent_dim=config.z_dim,
                         image_size=config.input_height, norm=config.E_norm,
                         use_resnet=config.if_resnet_e, in_ch=c_dim)

    @property
    def gen_input_dim(self) -> int:
        if self.config.multiclasses:
            return self.z_dim + self.config.num_classes
        return self.z_dim

    def gen_input(self, z, classes):
        """z [B, z_dim] ++ one_hot(classes) in z's dtype (multiclass)."""
        if not self.config.multiclasses:
            return z
        onehot = F.one_hot(classes.long(), self.config.num_classes)
        return torch.cat([z, onehot.to(z.dtype)], dim=1)

    def encode(self, x, eps):
        """NCHW sketch half, 0-d eps -> (z, mu, log_sigma)."""
        return self.E(x, eps)

    def generate(self, z_in):
        """Both generators on one latent -> NCHW (edge, image) halves."""
        return self.G1(z_in), self.G2(z_in)

    def cast(self, dtype: torch.dtype) -> 'Networks':
        """A copy with every weight in `dtype`, made once (the JAX package
        casts each weight to the input dtype per op: the same values).
        Batch-norm gamma/beta stay float32, as the JAX package reads them.
        """
        out = copy.deepcopy(self)
        for m in out.modules():
            if not isinstance(m, BatchNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)
        return out
