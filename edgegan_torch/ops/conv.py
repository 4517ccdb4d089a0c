"""Convolutions with TensorFlow's padding semantics, NCHW.

Weights are OIHW for `conv2d` and `[in, out, k, k]` for `deconv2d`
(PyTorch's layouts); the bridge permutes the JAX package's HWIO and
`[k, k, out, in]` kernels into them. Every op casts its weight to the
input dtype, as the JAX package does per op.

TF's SAME padding is asymmetric (the extra row/column goes at the end),
which `padding='same'` does not do for stride 2, so it is an explicit
`F.pad`. `conv2d_transpose` SAME is the full transposed convolution
cropped at the forward convolution's low padding.
"""
from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F


def same_pads(in_size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding (lo, hi) for one spatial axis."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k - in_size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 2, pad: str = 'SAME', bias=None):
    """x [B,C,H,W], w [out,in,k,k]. pad in {'SAME', 'VALID', 'REFLECT'};
    REFLECT pads by (k-1)//2 with mirror padding, then runs a VALID conv
    (reference conv.py:23-26)."""
    k = w.shape[-1]
    if pad == 'REFLECT':
        p = (k - 1) // 2
        if p:
            x = F.pad(x, (p, p, p, p), mode='reflect')
    elif pad == 'SAME':
        hl, hh = same_pads(x.shape[2], k, stride)
        wl, wh = same_pads(x.shape[3], k, stride)
        if hl or hh or wl or wh:
            x = F.pad(x, (wl, wh, hl, hh))
    elif pad != 'VALID':
        raise ValueError(f'unknown padding {pad!r}')
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, w.to(x.dtype), b, stride)


def deconv2d(x, w, out_hw: Tuple[int, int], stride: int = 2, bias=None):
    """tf.nn.conv2d_transpose SAME. x [B,in,h,w], w [in,out,k,k];
    `out_hw` is the static output size. The result is contiguous."""
    if tuple(x.shape[2:]) != tuple(-(-o // stride) for o in out_hw):
        raise ValueError(f'input {tuple(x.shape)} does not map to {out_hw} '
                         f'at stride {stride}')
    k = w.shape[-1]
    b = None if bias is None else bias.to(x.dtype)
    full = F.conv_transpose2d(x, w.to(x.dtype), b, stride)
    (hl, _), (wl, _) = (same_pads(o, k, stride) for o in out_hw)
    out = full[:, :, hl:hl + out_hw[0], wl:wl + out_hw[1]]
    return out.contiguous()
