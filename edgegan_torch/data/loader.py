"""Prefetching loader: decodes batches on a thread pool `prefetch` batches
ahead (the JAX package's data/loader.py) and hands them over as CPU
tensors, in pinned memory when `pin` is set so that the train loop's
`.to(device, non_blocking=True)` copies overlap the card's work."""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import torch


class PrefetchLoader:
    def __init__(self, dataset, prefetch: int = 2, num_workers: int = 8,
                 pin: bool = False):
        self.dataset = dataset
        self.prefetch = max(1, prefetch)
        self.pin = pin
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)

    def _fetch(self, idx):
        images, z, files = self.dataset[idx]
        images, z = torch.from_numpy(images), torch.from_numpy(z)
        if self.pin:
            images, z = images.pin_memory(), z.pin_memory()
        return images, z, files

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
