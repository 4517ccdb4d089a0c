"""The port's native PNG loader (`edgegan_torch/data/native_loader.py`)
and its place in the port's `Dataset`, against the JAX package's.

- The port's library decodes bit for bit what the JAX package's
  `native_loader.decode_batch` decodes (the same native/loader.cpp, built
  by the port into edgegan_torch/build/).
- Against the PIL path: the stretched 8-bit pixels are the same, so the
  decode equals `x / 127.5 - 1` of PIL's pixels in float32 bit for bit;
  `get_image` rounds that from float64, at most one float32 step (at
  1.0) away.
- A file of another size, a missing file and a JPEG set the fail mask.
- A port `Dataset` batch of PNGs at the output size equals the JAX
  `Dataset`'s bit for bit (also through `subdir`); files that need a
  resize, and every file when the library is unavailable, take the PIL
  path.
"""
import os

import numpy as np
import pytest
from PIL import Image

from edgegan_tpu.data import Dataset as JDataset
from edgegan_tpu.data import native_loader as jnative
from edgegan_torch.data import native_loader
from edgegan_torch.data.dataset import Dataset
from edgegan_torch.utils.images import get_image, imread, imresize
from test_torch_variants import few_threads  # noqa: F401

H, W = 32, 64
CFG = {'input_height': H, 'input_width': W, 'output_height': H,
       'output_width': W, 'crop': False, 'grayscale': False, 'z_dim': 4}


@pytest.fixture(scope='module')
def lib():
    lib = native_loader.get_lib()
    if lib is None:
        pytest.skip(f'native loader unavailable: {native_loader.build_error}')
    return lib


def make_png(path, h, w, seed, full_range=True):
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    if full_range:
        arr.flat[0], arr.flat[-1] = 0, 255
    else:
        arr = (arr % 100 + 50).astype(np.uint8)  # a narrow range: stretched
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)
    return path


@pytest.fixture(scope='module')
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp('png')
    return [make_png(str(d / f'{i}.png'), H, W, i, full_range=i % 2 == 0)
            for i in range(6)]


def test_library_is_built_in_the_package(lib):
    assert lib._name.startswith(native_loader.BUILD_DIR + os.sep)


def test_decode_matches_jax_native_bit_exact(lib, pngs):
    if jnative.get_lib() is None:
        pytest.skip('the JAX package\'s native loader is unavailable')
    got, fail = native_loader.decode_batch(pngs, H, W)
    want, jfail = jnative.decode_batch(pngs, H, W)
    assert not fail.any() and not jfail.any()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_matches_pil_path(lib, pngs):
    got, fail = native_loader.decode_batch(pngs, H, W)
    assert not fail.any()
    for img, path in zip(got, pngs):
        pixels = imresize(imread(path), (H, W))  # PIL + bytescale, uint8
        want = pixels.astype(np.float32) / np.float32(127.5) - np.float32(1)
        np.testing.assert_array_equal(img, want)
        pil = get_image(path, H, W, H, W, crop=False).astype(np.float32)
        np.testing.assert_allclose(img, pil, rtol=0,
                                   atol=np.finfo(np.float32).eps)


@pytest.mark.parametrize('bad', ['size', 'missing', 'jpeg'])
def test_fail_mask(tmp_path, lib, bad):
    good = make_png(str(tmp_path / 'good.png'), H, W, 0)
    if bad == 'size':
        other = make_png(str(tmp_path / 'small.png'), H // 2, W // 2, 1)
    elif bad == 'missing':
        other = str(tmp_path / 'nope.png')
    else:
        other = str(tmp_path / 'photo.jpg')
        Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(other)
    _, fail = native_loader.decode_batch([good, other], H, W)
    assert list(fail) == [False, True]


def _tree(root, split, sizes):
    for i, (h, w) in enumerate(sizes):
        make_png(os.path.join(root, 'ds', split, str(i % 2), f'{i}.png'),
                 h, w, seed=10 + i, full_range=i % 3 != 0)


@pytest.mark.parametrize('split', ['train', 'heldout'])
def test_dataset_batch_equals_jax_dataset(tmp_path, lib, split):
    root = str(tmp_path)
    _tree(root, split, [(H, W)] * 4)
    subdir = None if split == 'train' else split
    images, _, files = Dataset(root, 'ds', float('inf'), 4, CFG, 2,
                               subdir=subdir)[0]
    jimages, _, jfiles = JDataset(root, 'ds', float('inf'), 4, CFG, 2,
                                  'train', subdir=subdir)[0]
    assert files == jfiles
    assert images.dtype == np.float32
    np.testing.assert_array_equal(images, jimages)


def test_dataset_falls_back_to_pil(tmp_path, lib, monkeypatch):
    """Files that need a resize take the PIL path file by file; with no
    library every file does."""
    root = str(tmp_path)
    _tree(root, 'train', [(H, W), (H // 2, W // 2), (H, W), (H, W)])
    ds = Dataset(root, 'ds', float('inf'), 4, CFG, 2)
    images, _, files = ds[0]
    pil = np.stack([get_image(f, H, W, H, W, crop=False).astype(np.float32)
                    for f in files])
    resized = ['/1.png' in f.replace(os.sep, '/') for f in files]
    np.testing.assert_array_equal(images[resized], pil[resized])
    native, _ = native_loader.decode_batch(
        [f for f, r in zip(files, resized) if not r], H, W)
    np.testing.assert_array_equal(images[[not r for r in resized]], native)
    monkeypatch.setattr(native_loader, 'decode_batch', lambda *a, **k: None)
    np.testing.assert_array_equal(ds[0][0], pil)
