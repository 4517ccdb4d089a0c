"""Prefetching loader: decodes batches on a thread pool `prefetch` batches
ahead (the JAX package's data/loader.py) and hands them over as CPU
tensors, in pinned memory when `pin` is set so that the train loop's
`.to(device, non_blocking=True)` copies overlap the card's work. With
`image_dtype` the images are cast on the host (bfloat16 training copies
half the bytes, as the JAX trainer does). A training batch is (images,
z, files), a test batch (images, files); the file names pass through.
Under data parallelism the dataset's `shard` makes every batch this
rank's rows, which the caller copies to the rank's card
(`cuda:<LOCAL_RANK>`, the JAX loader's put of a process's shard,
l.40-49)."""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, Optional

import torch


class PrefetchLoader:
    def __init__(self, dataset, prefetch: int = 2, num_workers: int = 8,
                 pin: bool = False,
                 image_dtype: Optional[torch.dtype] = None):
        self.dataset = dataset
        self.prefetch = max(1, prefetch)
        self.pin = pin
        self.image_dtype = image_dtype
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)

    def _fetch(self, idx):
        *arrays, files = self.dataset[idx]
        images, *z = [torch.from_numpy(a) for a in arrays]
        if self.image_dtype is not None:
            images = images.to(self.image_dtype)
        if self.pin:
            images, *z = [t.pin_memory() for t in (images, *z)]
        return (images, *z, files)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        depth = min(self.prefetch, n)
        futures = {i: self.pool.submit(self._fetch, i) for i in range(depth)}
        for i in range(n):
            item = futures.pop(i).result()
            if i + depth < n:
                futures[i + depth] = self.pool.submit(self._fetch, i + depth)
            yield item

    def close(self):
        self.pool.shutdown(wait=False)
