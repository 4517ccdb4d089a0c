"""Image resize as two float32 matmuls, NCHW.

The reference resizes the patch critics' inputs with TF1
`tf.image.resize_images(..., method=2)`: bicubic, align_corners=False
(models/edgegan.py:211-213). TF1's legacy mapping is `src = dst * in/out`
with no half-pixel offset, a Keys cubic kernel with A = -0.75, and taps
clamped at the edges. `F.interpolate` uses half-pixel centres and does
not match. The per-axis interpolation matrices are built with numpy (the
JAX package's, ops/resize.py:23-57) and kept on each device once per
shape.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    s = np.abs(s)
    return np.where(
        s <= 1.0,
        (a + 2.0) * s ** 3 - (a + 3.0) * s ** 2 + 1.0,
        np.where(s < 2.0,
                 a * s ** 3 - 5.0 * a * s ** 2 + 8.0 * a * s - 4.0 * a, 0.0))


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] bicubic interpolation matrix, TF1 legacy."""
    dst = np.arange(out_size, dtype=np.float64)
    src = dst * (in_size / out_size)
    f = np.floor(src).astype(np.int64)
    t = src - f
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    weights = [_cubic_kernel(1.0 + t), _cubic_kernel(t),
               _cubic_kernel(1.0 - t), _cubic_kernel(2.0 - t)]
    for tap, wgt in zip((-1, 0, 1, 2), weights):
        idx = np.clip(f + tap, 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), wgt)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, device: torch.device):
    """`resize_matrix` on `device`, made outside inference mode so that a
    cached matrix can be saved for backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)


def resize(x, out_hw: Tuple[int, int]):
    """Bicubic resize of NCHW `x` to `out_hw`, in float32, cast back."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = out_hw
    out = x
    if oh != h:
        out = torch.einsum('oh,bchw->bcow', _matrix(h, oh, x.device),
                           out.float())
    if ow != w:
        out = torch.einsum('ow,bchw->bcho', _matrix(w, ow, x.device),
                           out.float())
    return out.to(x.dtype)
