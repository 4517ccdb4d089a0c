"""AC-GAN classifier (reference models/classifier.py; the JAX package's
models/classifier.py:23-61), NCHW.

A six-level mean-pool pyramid of the input, a 7x7 spectral-normed stem
(8 channels, prelu), four MRU units at depths 128/256/512/768 (each takes
the matching pyramid level and the previous hidden state, stride 2), a
last prelu, then two heads: a 1x1 patch output (`disc_head`, built but
unused by the losses; its parameters still exist and are trained with
zero gradients) and spatial mean -> spectral-normed dense `class_head`.
Returns (disc, sigmoid(logits), logits), and with `return_features` also
the 768-d spatial mean fed to `class_head` (the classifier-FID features,
`evaluation.py`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.pool import mean_pool
from .layers import MRUBlock, PReLU, SNConv2D, SNDense


class Classifier(nn.Module):
    def __init__(self, num_classes: int, in_ch: int = 3):
        super().__init__()
        self.h0 = SNConv2D(in_ch, 8, 7, activation='prelu')
        hidden = 8
        self.depths = [128, 256, 512, 768]   # the reference's size 64 x 2..12
        for unit, depth in enumerate(self.depths, start=1):
            setattr(self, f'mru_conv_unit_{unit}',
                    MRUBlock(in_ch, hidden, depth))
            hidden = depth
        self.mru_conv_unit_last_prelu = PReLU()
        self.disc_head = SNConv2D(hidden, 1, 1)
        self.class_head = SNDense(hidden, num_classes)

    def forward(self, x, return_features: bool = False):
        x_list = [x]
        for _ in range(5):
            x_list.append(mean_pool(x_list[-1]))
        x_list = x_list[::-1]  # x_list[-1] is the full-resolution input
        ht = self.h0(x_list[-1])
        for unit in range(1, len(self.depths) + 1):
            ht = getattr(self, f'mru_conv_unit_{unit}')(x_list[-unit], ht)
        ht = self.mru_conv_unit_last_prelu(ht)
        disc = self.disc_head(ht)
        feat = ht.mean(dim=(2, 3))
        logits = self.class_head(feat)
        if return_features:
            return disc, 1.0 / (1.0 + torch.exp(-logits)), logits, feat
        return disc, 1.0 / (1.0 + torch.exp(-logits)), logits
