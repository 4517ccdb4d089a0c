"""Inference path (reference models/edgegan.py:492-517 test graph):
encoder(sketch half) -> z -> [z ; one_hot(class)] -> G1, G2.

Parity quirk Q15: the reference runs the edge and the image outputs as
two separate graph executions, and the encoder's noise is drawn anew in
each, so with `separate_z` the two halves come from two eps. The encoder
itself is deterministic, so it runs once and only the sample
`mu + eps * exp(log_sigma)` is taken twice (XLA merges the two encoder
calls of the JAX version the same way).
"""
from __future__ import annotations

import torch

from .core.config import Config
from .models.encoder import reparameterize
from .train.networks import Networks


def exact_f32():
    """float32 means float32 on the card: cuDNN convolutions would run in
    TF32 by default (`cudnn.allow_tf32`), and matmuls stay at "highest"
    precision. bfloat16 work is unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def make_test_forward(nets: Networks, config: Config,
                      separate_z: bool = True):
    """forward(inputs, classes, eps=None, generator=None) -> (edge, image).

    `inputs` NHWC [B, H, W, 3] pairs (or just the left halves) in [-1, 1]
    in the dtype of `nets`; `classes` int [B]. `eps` is a tensor of two
    scalars (e1, e2); without it `generator` (a `torch.Generator` on the
    CPU) draws them. Returns NHWC [B, H, W/2, 3] edge and image halves.
    Under data parallelism each rank passes its rows of the batch inside
    `parallel.synced_batch_stats()` (`cli.test`, `serve`), so that the
    generators' batch norm (quirk Q14) sees the whole batch.
    """
    exact_f32()
    h = config.output_height
    half_w = int(config.output_width / 2)

    def forward(inputs, classes, eps=None, generator=None):
        if eps is None:
            eps = torch.randn(2, generator=generator)
        left = inputs[:, :h, :half_w, :].permute(0, 3, 1, 2)
        mu, log_sigma = nets.E.heads(left)
        z1 = nets.gen_input(reparameterize(mu, log_sigma, eps[0]), classes)
        z2 = (nets.gen_input(reparameterize(mu, log_sigma, eps[1]), classes)
              if separate_z else z1)
        edge = nets.G1(z1).permute(0, 2, 3, 1)
        image = nets.G2(z2).permute(0, 2, 3, 1)
        return edge, image

    return forward
