"""The procedural genshapes dataset (a copy of the JAX package's
scripts/genquality_run.py:50-218; the port imports nothing of it).

Up to 14 classes of filled shapes (circle, square, triangle, cross,
diamond, wide ellipse, star, pentagon, hexagon, ring, semicircle, L, T,
right triangle), each photo drawn on a smooth random colour field with
clutter lines and dots, the shape shaded by a second field, a vertical
brightness gradient and sensor noise; the edge half is derived from the
photo (per-channel gradient magnitude, dark soft strokes on white). The
pairs are laid out as the dataset expects:
<dataroot>/<dataset>/{train,test}/<class>/<i:04d>.png, each h x 2w.

`stage` draws from one `np.random.RandomState(seed)` in the JAX script's
order, so the same seed and Pillow give the same PNG bytes. The photo
size is a parameter here (`hw`), where the JAX script rewrites and
restores module globals.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

NUM_CLASSES = 4
TRAIN_PER_CLASS = 480
TEST_PER_CLASS = 24
HW = (64, 64)   # photo size (h, w); a pair is h x 2w


def _smooth_field(rng, hw, cells=5, lo=0.0, hi=1.0):
    """A smooth random colour field in [lo, hi]: a low-resolution random
    RGB grid, bilinearly upsampled to `hw`."""
    from PIL import Image
    h, w = hw
    grid = rng.uniform(lo, hi, (cells, cells, 3)).astype(np.float32)
    chans = [np.asarray(Image.fromarray(grid[:, :, c], mode='F')
                        .resize((w, h), Image.BILINEAR))
             for c in range(3)]
    return np.stack(chans, axis=2)


def _draw_shape(draw, class_id, cx, cy, r, fg, rng):
    """Draw class `class_id`'s filled shape (14 geometries)."""
    t = max(3, r // 2)
    if class_id == 0:    # circle
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=fg)
    elif class_id == 1:  # square
        draw.rectangle([cx - r, cy - r, cx + r, cy + r], fill=fg)
    elif class_id == 2:  # triangle
        draw.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)],
                     fill=fg)
    elif class_id == 3:  # cross
        draw.rectangle([cx - r, cy - t, cx + r, cy + t], fill=fg)
        draw.rectangle([cx - t, cy - r, cx + t, cy + r], fill=fg)
    elif class_id == 4:  # diamond
        draw.polygon([(cx, cy - r), (cx + r, cy), (cx, cy + r),
                      (cx - r, cy)], fill=fg)
    elif class_id == 5:  # wide ellipse
        draw.ellipse([cx - r, cy - t, cx + r, cy + t], fill=fg)
    elif class_id == 6:  # 5-point star
        pts = []
        for i in range(10):
            rad = r if i % 2 == 0 else max(2, int(r * 0.45))
            a = math.pi * i / 5 - math.pi / 2
            pts.append((cx + rad * math.cos(a), cy + rad * math.sin(a)))
        draw.polygon(pts, fill=fg)
    elif class_id == 7:  # pentagon
        pts = [(cx + r * math.cos(2 * math.pi * i / 5 - math.pi / 2),
                cy + r * math.sin(2 * math.pi * i / 5 - math.pi / 2))
               for i in range(5)]
        draw.polygon(pts, fill=fg)
    elif class_id == 8:  # hexagon
        pts = [(cx + r * math.cos(math.pi * i / 3),
                cy + r * math.sin(math.pi * i / 3)) for i in range(6)]
        draw.polygon(pts, fill=fg)
    elif class_id == 9:  # ring (annulus)
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=fg)
        hole = max(2, r - t)
        draw.ellipse([cx - hole, cy - hole, cx + hole, cy + hole],
                     fill=tuple(int(c) for c in rng.randint(0, 255, 3)))
    elif class_id == 10:  # semicircle
        draw.pieslice([cx - r, cy - r, cx + r, cy + r], 180, 360, fill=fg)
    elif class_id == 11:  # L-shape
        draw.rectangle([cx - r, cy - r, cx - r + 2 * t, cy + r], fill=fg)
        draw.rectangle([cx - r, cy + r - 2 * t, cx + r, cy + r], fill=fg)
    elif class_id == 12:  # T-shape
        draw.rectangle([cx - r, cy - r, cx + r, cy - r + 2 * t], fill=fg)
        draw.rectangle([cx - t, cy - r, cx + t, cy + r], fill=fg)
    else:                 # right triangle
        draw.polygon([(cx - r, cy - r), (cx - r, cy + r),
                      (cx + r, cy + r)], fill=fg)


def _draw_photo(rng, class_id, hw):
    """One randomised h x w photo (uint8 [h, w, 3]) of the class's shape.
    Textured everywhere: a flat background is the regime where the WGAN
    critics diverge."""
    from PIL import Image, ImageDraw
    h, w = hw

    def color(lo=0, hi=255):
        return tuple(int(c) for c in rng.randint(lo, hi, 3))

    arr = _smooth_field(rng, hw, cells=int(rng.randint(4, 8)),
                        lo=0.1, hi=0.9) * 255.0
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for _ in range(rng.randint(2, 5)):   # clutter: thin lines
        p = [int(rng.randint(0, w)), int(rng.randint(0, h)),
             int(rng.randint(0, w)), int(rng.randint(0, h))]
        draw.line(p, fill=color(), width=1)
    for _ in range(rng.randint(3, 8)):   # and small dots
        x, y, r = rng.randint(0, w), rng.randint(0, h), rng.randint(1, 3)
        draw.ellipse([x - r, y - r, x + r, y + r], fill=color())
    bg_mean = np.asarray(img, np.float32).mean(axis=(0, 1))
    fg = color(30, 225)
    while np.abs(np.subtract(fg, bg_mean)).sum() < 180:  # contrast
        fg = color(30, 225)
    s = h // 64                          # the radius grows with the canvas
    r = rng.randint(12 * s, 22 * s)
    cx = rng.randint(r + 4, w - r - 4)
    cy = rng.randint(r + 4, h - r - 4)
    _draw_shape(draw, class_id, cx, cy, r, fg, rng)
    arr = np.asarray(img, np.float32)
    shade = (_smooth_field(rng, hw, cells=4, lo=-0.25, hi=0.25)
             .mean(axis=2, keepdims=True) + 1.0)
    arr = arr * shade
    grad = np.linspace(-18, 18, h, dtype=np.float32)[:, None, None]
    arr = arr + grad * rng.uniform(0.0, 1.0) + rng.normal(0, 3, arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def _edge_map(photo):
    """Photo -> its edge half: the per-channel gradient magnitude, max over
    channels, as soft dark strokes on white."""
    g = photo.astype(np.float32)
    gy, gx = np.gradient(g, axis=(0, 1))
    mag = np.sqrt(gx * gx + gy * gy).max(axis=2)
    edge = np.clip(255.0 - mag * 6.0, 0, 255).astype(np.uint8)
    return np.repeat(edge[:, :, None], 3, axis=2)


def stage(dataroot: str, seed: int = 7,
          train_per_class: int = TRAIN_PER_CLASS,
          test_per_class: int = TEST_PER_CLASS,
          num_classes: int = NUM_CLASSES, dataset: str = 'genshapes',
          hw: Optional[Tuple[int, int]] = None):
    """Write the train and test splits of `dataset` under `dataroot`, the
    photos at `hw` (h, w; default 64x64). Returns the (train, test) pair
    counts."""
    from PIL import Image
    hw = tuple(hw) if hw is not None else HW
    rng = np.random.RandomState(seed)
    counts = {'train': train_per_class, 'test': test_per_class}
    for split, per_class in counts.items():
        for cls in range(num_classes):
            d = os.path.join(dataroot, dataset, split, str(cls))
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                photo = _draw_photo(rng, cls, hw)
                pair = np.concatenate([_edge_map(photo), photo], axis=1)
                Image.fromarray(pair).save(os.path.join(d, f'{i:04d}.png'))
    return counts['train'] * num_classes, counts['test'] * num_classes
