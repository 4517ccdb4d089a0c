"""File-glob dataset (reference utils/data/dataset.py; a copy of the JAX
package's data/dataset.py:22-210).

Directory semantics kept exactly:
  train, multiclass:  <dataroot>/<name>/train/<classid>/*.{png,jpg}
  train, flat:        <dataroot>/<name>/train/*.png
  test:               <dataroot>/<name>/test/**/*.{png,jpg}, recursive,
                      sorted
`subdir` replaces the split directory ('train' or 'test') and keeps the
phase's listing, so that a train-style listing (class directories, z)
can point at any split of paired images (`cli.evaluate --split`).
In training the class id is parsed from the parent directory's name; the
last partial batch is dropped (quirk Q10), unless `pad_tail` (test phase
only), which pads it to a full batch with repeats of its last file,
named `Dataset.PAD` so that callers drop those rows. The shuffle is
seeded by `seed`. A training batch is (images, z, files), a test batch
(images, files).

Data parallelism: with `shard=(rank, world)` the batch size stays the
global one, every rank shuffles alike (the same seeded stream) and each
decodes and returns only its contiguous rows of every global batch; a
padded tail is padded as a whole first, so the ranks' rows join into the
one-process batch.

z: with `host_z`, every batch carries its own N(0, 1) latents, derived
from a counter (seed, rank, shuffle generation, batch index) so that
they do not depend on which prefetch thread decodes the batch (the JAX
dataset's stream, bit for bit, l.173-202), followed by the class-id
column; without it (the default) only the class-id column is
returned and the train step draws z on the device.

Decoding: without crop or grayscale, a batch's PNGs already at the output
size go through the native C++ decoder (`native_loader.py`), which gives
the JAX dataset's float32 values bit for bit; every other file, and every
file when the decoder cannot be built, is decoded with PIL (`get_image`,
which rounds `x / 127.5 - 1` from float64).
"""
from __future__ import annotations

import os
from glob import glob
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.images import get_image


class Dataset:
    #: the file name of a padded row of a tail batch (`pad_tail`)
    PAD = '<pad>'

    def __init__(self, dataroot: str, name: str, size, batchsize: int,
                 config: dict, num_classes: Optional[int] = None,
                 cache: bool = False, seed: int = 0, host_z: bool = False,
                 phase: str = 'train', pad_tail: bool = False,
                 subdir: Optional[str] = None, shard=(0, 1)):
        """`config` holds input_height/width, output_height/width, crop,
        grayscale and (training) z_dim. `cache=True` keeps every decoded
        image in RAM after first use. `shard`: (rank, world), whose rows
        of each global batch of `batchsize` this rank returns."""
        if phase not in ('train', 'test'):
            raise ValueError(f'phase {phase!r}: train or test')
        if pad_tail and phase != 'test':
            raise ValueError('pad_tail is a test-phase option')
        self.phase, self.pad_tail = phase, pad_tail
        self.batchsize = batchsize   # the global batch
        self.rank, self.world = shard
        if batchsize % self.world:
            raise ValueError(f'batch {batchsize} over {self.world} ranks')
        self.local_batchsize = batchsize // self.world
        self.num_classes = num_classes
        self.config = config
        self.cache = cache
        self._cache: dict = {}
        self.host_z = host_z
        self._z_base = seed
        self._shuffle_gen = 0
        self.rng = np.random.RandomState(seed)
        subdir = subdir or phase
        if phase == 'test':
            data_path = os.path.join(dataroot, name, subdir)
            self.data = sorted(str(p) for ext in ('*.png', '*.jpg')
                               for p in Path(data_path).rglob(ext))
        elif num_classes is not None:
            self.data = []
            for i in range(num_classes):
                for ext in ('*.png', '*.jpg'):
                    self.data.extend(glob(os.path.join(
                        dataroot, name, subdir, str(i), ext)))
            data_path = os.path.join(dataroot, name, subdir)
        else:
            data_path = os.path.join(dataroot, name, subdir, '*.png')
            self.data = glob(data_path)
        if not self.data:
            raise FileNotFoundError(f"[!] No data found in '{data_path}'")
        if len(self.data) < batchsize and not pad_tail:
            raise ValueError('[!] Entire dataset size is less than the '
                             'configured batch_size')
        self.size = int(min(len(self.data), size))

    def shuffle(self):
        self.rng.shuffle(self.data)
        self._shuffle_gen += 1  # advances the per-epoch z streams

    def __len__(self):
        if self.pad_tail:
            return -(-self.size // self.batchsize)
        return self.size // self.batchsize  # drops the last partial batch

    def _load_pil(self, f):
        return np.asarray(get_image(
            f, input_height=self.config['input_height'],
            input_width=self.config['input_width'],
            resize_height=self.config['output_height'],
            resize_width=self.config['output_width'],
            crop=self.config['crop'],
            grayscale=self.config['grayscale']), np.float32)

    def _native_eligible(self):
        """The native decoder takes the no-crop, no-grayscale case (and
        within it PNGs at the output size, file by file)."""
        return not self.config['crop'] and not self.config['grayscale']

    def _load_batch(self, files):
        store = self._cache if self.cache else {}
        missing = [f for f in files if f not in store]
        if missing and self._native_eligible():
            from . import native_loader
            res = native_loader.decode_batch(
                missing, self.config['output_height'],
                self.config['output_width'])
            if res is not None:
                for f, img, bad in zip(missing, *res):
                    if not bad:
                        store[f] = img
        out = []
        for f in files:
            img = store.get(f)
            if img is None:
                img = self._load_pil(f)
                if self.cache:
                    store[f] = img
            out.append(img)
        return np.stack(out)

    def batch_files(self, idx):
        """(paths to decode, file names) of global batch `idx`: a padded
        tail repeats its last file in the paths and names those rows
        `PAD`."""
        files = self.data[idx * self.batchsize:(idx + 1) * self.batchsize]
        n_pad = self.batchsize - len(files) if self.pad_tail else 0
        return files + files[-1:] * n_pad, files + [self.PAD] * n_pad

    def __getitem__(self, idx):
        """-> (images [B, H, W, 3] float32 in [-1, 1], z [B, feed width]
        float32, file names) in training, (images, file names) in the
        test phase; B is this rank's rows of the global batch."""
        paths, names = self.batch_files(idx)
        lo = self.rank * self.local_batchsize
        paths = paths[lo:lo + self.local_batchsize]
        files = names[lo:lo + self.local_batchsize]
        images = self._load_batch(paths)
        if self.phase == 'test':
            return images, files
        classes = None
        if self.num_classes is not None:
            classes = np.array(
                [int(os.path.basename(os.path.dirname(f))) for f in files],
                np.float32).reshape(-1, 1)
        if self.host_z:
            zrng = np.random.default_rng(np.random.SeedSequence(
                [self._z_base, self.rank, self._shuffle_gen, idx]))
            z = zrng.normal(size=(len(files), self.config['z_dim'])).astype(
                np.float32)
            if classes is not None:
                z = np.concatenate([z, classes], axis=1)
        else:
            z = (classes if classes is not None else
                 np.zeros((len(files), 0), np.float32))
        return images, z, files
