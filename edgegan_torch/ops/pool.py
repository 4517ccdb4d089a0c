"""Pooling, NCHW.

- `mean_pool`: the reference's 2x2 average (pooling.py:4-8), used by the
  classifier's pyramid and its MRU units.
- `tf_avg_pool`: tf.nn.avg_pool SAME, padding left out of the divisor.
- `upsample_nearest`: the 2x nearest repeat of the resnet generator.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .conv import same_pads


def _axis_counts(in_size: int, window: int, stride: int) -> np.ndarray:
    """Valid (unpadded) elements under each SAME window along one axis."""
    out_size = -(-in_size // stride)
    lo, _ = same_pads(in_size, window, stride)
    starts = np.arange(out_size) * stride - lo
    ends = starts + window
    return (np.minimum(ends, in_size) - np.maximum(starts, 0)).astype(
        np.float32)


@functools.lru_cache(maxsize=64)
def _counts(h: int, w: int, window: int, stride: int, device: torch.device):
    """The static divisor matrix, copied to the device once per shape (a
    copy from pageable memory on every call would stall the host). Made
    outside inference mode, so that a matrix first cached by serving can
    be saved for backward by training in the same process."""
    counts = np.outer(_axis_counts(h, window, stride),
                      _axis_counts(w, window, stride))
    with torch.inference_mode(False):
        return torch.from_numpy(counts).to(device)


def mean_pool(x):
    """2x2 average over non-overlapping windows of NCHW `x`; H and W even."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f'mean_pool needs even H and W, got {h}x{w}')
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def tf_avg_pool(x, window: int, stride: int):
    """tf.nn.avg_pool(x, [1,w,w,1], [1,s,s,1], 'SAME') on NCHW `x`.

    TF leaves SAME padding out of the divisor, and `F.avg_pool2d` cannot
    pad asymmetrically: pad with zeros, sum-pool, and divide by the
    static count of valid elements per window. Computed in float32.
    """
    h, w = x.shape[2], x.shape[3]
    hl, hh = same_pads(h, window, stride)
    wl, wh = same_pads(w, window, stride)
    x32 = F.pad(x.float(), (wl, wh, hl, hh))
    summed = F.avg_pool2d(x32, window, stride, divisor_override=1)
    return (summed / _counts(h, w, window, stride, x.device)).to(x.dtype)


def upsample_nearest(x):
    """2x nearest-neighbour upsample of NCHW `x`: each pixel fills a 2x2
    cell (the reference's channel tile + depth_to_space,
    upsampling.py:4-19; the JAX package's ops/pool.py:54-64)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)
