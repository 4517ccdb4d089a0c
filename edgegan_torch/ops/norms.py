"""Normalisations, NCHW (reference nn/modules/normalization.py).

- instance_norm: `(x - mean) / (sqrt(var) + eps)`, eps OUTSIDE the sqrt,
  no learnable scale/shift (quirk Q1), population variance over H, W.
- batch_norm: train-mode batch statistics (the reference hard-codes
  `is_training=True`, quirk Q14), learnable gamma/beta, eps INSIDE the
  sqrt, computed in float32 and cast back.
- spectral_normalize: one power iteration from a stored `u` (reference
  normalization.py:38-76); `u` itself stays frozen (quirk Q3) unless the
  caller stores the u_new it returns (`update_sn`).

Statistics are float32 whatever the input dtype.
"""
from __future__ import annotations

import os

import torch


def nan_guards_enabled() -> bool:
    """EDGEGAN_NAN_GUARDS=0 turns off the zero-variance `where` guards,
    making the numerics reference-exact including its NaN hazards. Read
    at call time."""
    return os.environ.get('EDGEGAN_NAN_GUARDS', '1') != '0'


def _denom(var, eps: float):
    """sqrt(var) + eps; at var == 0 (a constant plane) the guarded form
    returns eps with a zero gradient instead of the sqrt's NaN."""
    if nan_guards_enabled():
        nondegenerate = var > 0
        safe_var = torch.where(nondegenerate, var, torch.ones_like(var))
        return torch.where(nondegenerate, torch.sqrt(safe_var) + eps,
                           torch.full_like(var, eps))
    return torch.sqrt(var) + eps


def instance_norm(x, eps: float = 1e-5):
    """Instance norm over the spatial axes of NCHW `x`.

    float32 takes the reference path. Other dtypes keep the statistics
    in float32 and normalise in the input dtype, as the JAX package does
    for bfloat16 (ops/norms.py:69-79).
    """
    if x.dtype == torch.float32:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = torch.square(x - mean).mean(dim=(2, 3), keepdim=True)
        return (x - mean) / _denom(var, eps)
    mean32 = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
    diff = x - mean32.to(x.dtype)
    var = torch.square(diff).mean(dim=(2, 3), keepdim=True,
                                  dtype=torch.float32)
    return diff * (1.0 / _denom(var, eps)).to(x.dtype)


def batch_norm(x, gamma, beta, eps: float = 1e-5):
    """Train-mode batch norm (tf.contrib batch_norm with is_training=True,
    epsilon=1e-5) with the channels on axis 1: NCHW, or a 2-D [B, F]
    whose F features are the channels. The statistics run over every
    other axis, as the JAX package's over all but its last
    (ops/norms.py:82-95). Returns (out, mean, var)."""
    x32 = x.float()
    axes = (0,) + tuple(range(2, x.dim()))
    mean = x32.mean(dim=axes, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    out = out * gamma.float().view_as(mean) + beta.float().view_as(mean)
    return out.to(x.dtype), mean.reshape(-1), var.reshape(-1)


def _l2normalize(v, eps: float = 1e-12):
    """v / (sqrt(sum(v^2)) + eps) (reference normalization.py:35-36)."""
    return v / (torch.sum(v * v) ** 0.5 + eps)


def spectral_normalize(w, u):
    """One power-iteration step from `u` [1, out]; returns (w_bar, u_new).

    `w` is in the port's layout, output channels first (OIHW for a conv,
    [out, in] for a dense layer). Its matrix `[-1, out]` is the
    reference's (normalization.py:39-40) up to the order of its rows,
    which leaves sigma unchanged. The gradient flows through sigma and
    through the iteration, as it does in the JAX package; u_new is not
    detached either, and the caller decides whether to keep it.
    """
    w_mat = w.reshape(w.shape[0], -1).t().float()
    v = _l2normalize(u.float() @ w_mat.t())
    u_new = _l2normalize(v @ w_mat)
    sigma = (v @ w_mat @ u_new.t())[0, 0]
    return (w.float() / sigma).to(w.dtype), u_new.to(u.dtype)
