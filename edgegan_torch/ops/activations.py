"""Activation functions (reference nn/modules/activation.py:4-32)."""
from __future__ import annotations

from typing import Optional

import torch


def relu(x):
    return torch.relu(x)


def lrelu(x, leak: float = 0.2):
    """Leaky ReLU, `max(x, leak*x)` (reference activation.py:9,30-32)."""
    return torch.maximum(x, leak * x)


def prelu(x, leak):
    """PReLU with a learnable scalar leak, `max(leak*x, x)` (reference
    activation.py:23-27). At a tie (x == 0) `torch.maximum` splits the
    cotangent 0.5/0.5, as `jnp.maximum` does."""
    return torch.maximum(leak * x, x)


def activation_fn(x, name: Optional[str]):
    """Dispatch by name (reference activation.py:4-15)."""
    if name is None:
        return x
    if name == 'relu':
        return relu(x)
    if name == 'lrelu':
        return lrelu(x)
    if name == 'tanh':
        return torch.tanh(x)
    raise ValueError(f'unknown activation: {name!r}')
