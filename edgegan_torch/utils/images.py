"""Host-side image I/O and transforms for the PNG route (numpy + PIL).

A copy of the JAX package's utils/images.py:22-136, which matches the
reference's scipy.misc behaviour: `imresize` on a float array first
stretches the array's own [min, max] onto [0, 255] (`bytescale`), and
saving (`imsave`, `save_images`) stretches again.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from PIL import Image


def bytescale(data: np.ndarray, cmin: Optional[float] = None,
              cmax: Optional[float] = None) -> np.ndarray:
    """scipy.misc.bytescale: linear stretch of [cmin, cmax] -> [0, 255]."""
    if data.dtype == np.uint8:
        return data
    cmin = float(data.min()) if cmin is None else cmin
    cmax = float(data.max()) if cmax is None else cmax
    cscale = cmax - cmin
    if cscale == 0:
        cscale = 1
    scale = 255.0 / cscale
    out = (data - cmin) * scale + 0.4999  # scipy rounds via +0.5 cast
    return np.clip(out, 0, 255).astype(np.uint8)


def imread(path: str, grayscale: bool = False) -> np.ndarray:
    """scipy.misc.imread (utils.py:126-130): a float array."""
    img = Image.open(path)
    img = img.convert('F' if grayscale else 'RGB')
    return np.asarray(img, dtype=np.float64)


def imresize(arr: np.ndarray, size: Tuple[int, int],
             interp: str = 'bilinear') -> np.ndarray:
    """scipy.misc.imresize: bytescale -> PIL resize -> uint8. `size` is
    (height, width)."""
    data = bytescale(arr)
    resample = {'nearest': Image.NEAREST, 'bilinear': Image.BILINEAR,
                'bicubic': Image.BICUBIC}[interp]
    img = Image.fromarray(data)
    img = img.resize((size[1], size[0]), resample=resample)
    return np.asarray(img)


def center_crop(x: np.ndarray, crop_h: int, crop_w: Optional[int],
                resize_h: int = 64, resize_w: int = 64) -> np.ndarray:
    """utils.py:138-145."""
    if crop_w is None:
        crop_w = crop_h
    h, w = x.shape[:2]
    j = int(round((h - crop_h) / 2.0))
    i = int(round((w - crop_w) / 2.0))
    return imresize(x[j:j + crop_h, i:i + crop_w], (resize_h, resize_w))


def transform(image: np.ndarray, input_height: int, input_width: int,
              resize_height: int = 64, resize_width: int = 64,
              crop: bool = True) -> np.ndarray:
    """utils.py:148-160: crop/resize then scale to [-1, 1]."""
    if crop:
        cropped = center_crop(image, input_height, input_width,
                              resize_height, resize_width)
    else:
        cropped = imresize(image, (resize_height, resize_width))
    return np.asarray(cropped, dtype=np.float64) / 127.5 - 1.0


def inverse_transform(images: np.ndarray) -> np.ndarray:
    """utils.py:163-164."""
    return (images + 1.0) / 2.0


def get_image(path: str, input_height: int, input_width: int,
              resize_height: int = 64, resize_width: int = 64,
              crop: bool = True, grayscale: bool = False) -> np.ndarray:
    """utils.py:41-50: read, crop/resize, scale to [-1, 1]."""
    return transform(imread(path, grayscale), input_height, input_width,
                     resize_height, resize_width, crop)


def merge(images: np.ndarray, size) -> np.ndarray:
    """Grid compositor (utils.py:67-86) for colour images: [N, h, w, 3 or
    4] -> one [size[0] * h, size[1] * w, c] sheet."""
    _, h, w, c = images.shape
    if c not in (3, 4):
        raise ValueError('merge(images, size): images must be HxWx3/4')
    img = np.zeros((h * size[0], w * size[1], c))
    for idx, image in enumerate(images):
        i, j = idx % size[1], idx // size[1]
        img[j * h:j * h + h, i * w:i * w + w, :] = image
    return img


def imsave(images: np.ndarray, size, path: str):
    """scipy.misc.imsave (utils.py:133-135): the sheet stretched onto
    [0, 255] by `bytescale`, then written by PIL."""
    data = bytescale(np.squeeze(merge(images, size)))
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    Image.fromarray(data).save(path)


def save_images(images: np.ndarray, size, image_path: str):
    """utils.py:53-54: [-1, 1] images -> one PNG sheet."""
    return imsave(inverse_transform(images), size, image_path)


def makedirs(path: str):
    os.makedirs(path, exist_ok=True)
