"""Network bundle (the JAX package's train/networks.py:27-142).

Submodule names are the reference's variable scopes ('G1', 'G2', 'D',
'D_patch2', 'D_patch3', 'D2', 'E'), so `bridge.py` maps the JAX parameter
trees onto them by name. Inference and serving build G1, G2 and E only;
training (`critics=True`) adds the joint critic D over the full pair, the
image and edge patch critics over bicubic crops (when enabled) and the
classifier D2 (multiclass only).
"""
from __future__ import annotations

import copy
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import Config
from ..models.classifier import Classifier
from ..models.discriminator import Discriminator
from ..models.encoder import Encoder
from ..models.generator import Generator
from ..models.layers import BatchNorm


class Networks(nn.Module):
    def __init__(self, config: Config, gf_dim: int = 64, df_dim: int = 64,
                 c_dim: int = 3, critics: bool = False):
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
        if critics:
            dis = dict(num_filters=df_dim, norm=config.D_norm,
                       use_resnet=config.if_resnet_d, in_ch=c_dim)
            self.D = Discriminator(
                (config.output_height, config.output_width), **dis)
            if config.use_image_discriminator:
                self.D_patch2 = Discriminator((config.image_dis_size,) * 2,
                                              **dis)
            if config.use_edge_discriminator:
                self.D_patch3 = Discriminator((config.edge_dis_size,) * 2,
                                              **dis)
            if config.multiclasses:
                self.D2 = Classifier(config.num_classes, in_ch=c_dim)
        self.E = Encoder(latent_dim=config.z_dim,
                         image_size=config.input_height, norm=config.E_norm,
                         use_resnet=config.if_resnet_e, in_ch=c_dim)

    @property
    def names(self) -> Tuple[str, ...]:
        """The networks this bundle holds, in the reference's order."""
        return tuple(n for n in ('G1', 'G2', 'D', 'D_patch2', 'D_patch3',
                                 'D2', 'E') if hasattr(self, n))

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

    def discriminate(self, name: str, x):
        """Critic `name` ('D', 'D_patch2', 'D_patch3') -> (sigmoid, logit)."""
        return getattr(self, name)(x)

    def classify(self, x):
        """NCHW photo half -> (disc, sigmoid(logits), logits)."""
        return self.D2(x)

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
